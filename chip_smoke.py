"""On-card smoke test of the PyTorch/CUDA port (`storygen_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It takes no arguments and runs fourteen phases, all of which must pass. The
serving and training paths run in the default conv configuration and in
the fused-conv one (`ConvKernels(fused_prologue=True, strided=True)`: every
resnet conv on kernel P with its GroupNorm + SiLU as prologue, every 3x3
stride-2 conv on kernel D); in both, every 2x upsample and its conv run as
kernel U, the four phase convs on the source grid, and in training its
input gradient as kernel UB, their adjoint at stride 2 with a 4x4 window:
  kernels      builds the eleven CUDA kernels from storygen_tpu_torch/csrc/
               and holds each against its plain PyTorch version at the
               512 px shapes of the main paths (serving and stage-2
               training), M, L, DQ and DKV also at the mid block's
               reference spans of a 256 and a 768 px image (16 and 144
               tokens, which straddle the kernels' 64-row K/V tiles), F,
               L, DQ and DKV also at a ragged 1000 x 333 shape, L, DQ and
               DKV also at the training path's d 80 sites (attn1 and
               masked attn3 L2), at an odd 999 x 333 one (DKV's lse and
               delta by plain loads, not TMA) and on k and v read from a
               k|v split view, F, L, DQ,
               DKV, G, C and P also at a tensor-parallel rank's shard
               shapes (tp = 2, 4 for F, G, C and P, and every level's G
               shard at tp = 8), C, P
               and D also at the tiles of 16- and 8-column images, D at
               an odd width and at one input column with a Cout that 8
               does not divide, C at the input gradient's shape, and P
               also against kernel C run
               on the prologue already applied, with CUDA-event times for
               the kernel, its plain version and, where one PyTorch call
               computes the same function, that call (timed only, as a
               yardstick; the port never calls it), beside the kernel's
               bound (for F, M, L, DQ and DKV also one exp per kept logit
               at the special-function units' rate, with the binding term
               printed), F and M also on k and v read from a k|v split
               view of one tensor, for F, M, L, DQ, DKV, C, P and D their
               rate in TFLOP/s, for F, M, C and D their factor over SDPA
               or cuDNN and for L over the one SDPA call that returns a
               logsumexp (its flash kernel, or with a keep mask its
               memory-efficient kernel on the mask as an additive bias;
               it computes O too), for each backward case SDPA's backward
               alone (its forward run outside the timed calls) and
               DQ+DKV's factor over it,
               and for G (at every feed-forward site class of serving, its
               reference pass and training) its share of its bound, its
               GB/s, the device time of a call alone (torch.profiler) and
               the time of the unfused bf16 chain of PyTorch calls (a
               yardstick, not G's function), and for C, P, D, F,
               M, L, DQ and DKV their share of their bound, the device time
               of a call's kernels alone (torch.profiler) and the host's
               cost of a call through the wrapper and of its C launcher
               alone, DQ and DKV run twice at every case and equal bit for
               bit; then,
               at the sites whose wgmma line splits the reduction (UNet
               L3, mid, up block 1), C run twice bit for bit, C at B3
               against its three B1 calls bit for bit and against its
               plain version; the same of D at UNet L3 and the VAE
               encoder's 128 px site and of L at attn1 L1 and masked attn3
               L1 (each run twice, at B3 and B4 or B4 against its
               per-image calls, and against its plain version); the same
               of G at L3, mid, mid train and a ragged M (run twice, at B3
               and B4 against its per-image calls, and against its plain
               version); U at the UNet's three up blocks (B3, and B6 of
               the reference pass), the VAE decoder's three (B1) and a
               ragged B2 5x6 source, with the parent's path (upsampling
               copies, then C on the 2x grid) and F.interpolate + cuDNN's
               conv2d as yardsticks, mean and device time alone, and
               cuDNN's transposed conv as its library call; U at B3 and
               B6 against its per-image calls bit for bit, twice bit for
               bit and against its plain version; UB at the training
               path's three up blocks (B4), a ragged B2 5x6 source and a
               one-column B2 7x1 one, with the parent's path (C on the 2x
               grid and the fp32 2x2 sum) as yardstick, mean and device
               time alone, and cuDNN's 4x4 stride-2 conv2d with the
               transposed phase weights as its library call; UB at B1,
               B2 and B4 against its per-image calls bit for bit, twice
               bit for bit and against its plain version; and ptxas's
               registers and spills of every wgmma conv line (C, P, D, U
               and UB) and
               every F / M / L / DQ / DKV / G line (a spill fails the
               phase, and so does a wgmma that ptxas serialises);
  models       in each configuration: one full-width UNet image-cycle pass
               (512 px, 3 refs) and one 512 px VAE encode and decode,
               kernel path against the plain path on the card, compared
               before any clamp; and one full-width stage-2 main pass (B2,
               512 px, 3 refs under a ref mask) whose loss and attn3
               gradients are compared the same way;
  story        a 4-prompt auto-regressive `generate_story` at 512x512 with
               the full-width SD-1.5 + VLCM UNet, VAE and CLIP text encoder
               (seeded random weights and token ids), checking the frames,
               that every serving kernel ran on that path, and P and D not;
  train        one stage-2 micro-step at 256 px (batch 4, 3 refs, attn3
               spans of 16 tokens at the mid block) on the kernel path
               against the plain path; then
               `train("stage2", ...)` at 512 px, batch 4, 3 refs, bf16,
               gradient checkpointing, 2 micro-steps per optimizer step, 3
               optimizer steps on seeded synthetic batches, checking finite
               losses, that every attn3 parameter moved and nothing else
               did, that the nine kernels of the default configuration ran
               on that path, and P and D not (on every training path C's
               and UB's launches add up to C's before UB took U's input
               gradient from it, C_LAUNCHES_BEFORE_UB);
  story_fused  a 2-prompt story in the fused configuration: every serving
               kernel, P and D ran;
  serving      the serving options at 512 px, bf16, full width: each of the
               six samplers (DDIM with eta 0.5) on one auto-regressive
               frame with 3 refs at 4 steps, its ms per denoise step, and
               that it launched F, G, C and U and nothing else; stage
               "multi-image-condition" (3 refs, 2 steps, one reference
               pass of (N+1)B rows) kernel path against plain path in
               both configurations, P and D launched in the fused one,
               with the steps that carry the final latents' difference
               (the encoded references, each step's reference context,
               each CFG branch's eps and the guided eps, the latents after
               each step);
               ref_feature_interval 2 against 1 (half the reference
               passes, half their launches); generate_story(fused=True)
               against the per-frame story on the same draws (3 frames,
               DDIM-4: frame 1 bit for bit, the rest within
               ROLLOUT_REL_L2), then the VAE encoder's batch dependence
               behind the later frames' difference (frames 1-2 encoded
               together and one at a time, every module's output compared;
               a port kernel that depends on the batch fails the phase);
               and 2 images per prompt with a negative prompt;
  train_fused  1 optimizer step of 2 micro-steps in the fused
               configuration: all eleven kernels ran;
  checkpoint   the full-width seeded bf16 models through
               StoryGenPipeline.save_pretrained into build/ and back
               through load_diffusers_pretrained onto the card (every
               tensor equal bit for bit, with the seconds and bytes of the
               save and the load); a 2-frame DDIM-4 story from the loaded
               pipeline equal bit for bit to the source pipeline's on the
               same draws, launching F, G, C and U; and a UNet file without
               the attn3/norm4 keys loading with attn3 == attn1 and
               norm4 == norm1;
  train_more   from that folder, at 512 px, batch 4, bf16, gradient
               checkpointing: train("stage1") and train("coco") (finite
               losses, only the stage's subset moved, their launches: no
               M); train("stage2") on .npz posterior moments that the
               loaded VAE encodes on the card, with AdamW8bit, a checkpoint
               every optimizer step, an export and a SampleLogger PNG at
               step 2 (the VAE encoder runs fewer times than micro-steps);
               a run resumed from checkpoint 1 equal bit for bit to the
               uninterrupted one; that resumed run, which writes no
               export, exported offline by scripts.export_checkpoint (its
               own process, no card visible) equal tensor for tensor to
               the uninterrupted run's in-loop export of step 2, and a
               2-frame DDIM-4 story from each folder, equal bit for bit;
               and the peak memory of a step with 8-bit against fp32
               moments;
  cli          the entry points of storygen_tpu_torch/scripts/, called
               through their main(argv) from the checkpoint phase's folder
               at 512 px and full width: a BPE tokenizer written with
               Tokenizer.save_pretrained (ids below 49408, CLIP's bos and
               eos ids); a StorySalon tree of 512 px PNGs; precompute_latents
               over it; train stage 2 (2 optimizer steps, batch 4) from the
               images (from a YAML config where PyYAML is installed) with an
               export, then from the latents with AdamW8bit; inference from
               the export, a 3-frame DDIM-4 story whose PNGs, read back,
               equal the pipeline's frames for the seed; serve on
               127.0.0.1 port 0 (GET /healthz, POST /story of 2 frames);
               each path's launches (F, G, C, U serving; M, L, DQ, DKV also
               training) and wall time;
  dataset      the dataset-building path (data_process/, detection/,
               native/, utils/profiling): the native library's g++ build
               and its three functions on 16 frames of 512 px, bit for bit
               against their numpy forms; YOLOv7 at full P5 width, fp32,
               640 px, from a seeded upstream train-form checkpoint
               through load_torch_state and the importer, its detect
               inputs and head maps less their bias against the same
               module on the CPU (YOLO_REL_L2; cuDNN keeps its TF32
               default), its NMS on one decoded tensor on the card and the
               CPU (the same boxes), ms per detect; inpainting at 512 px,
               DDIM-25, a rectangular mask, from the checkpoint folder in
               both conv configurations (unmasked latents and pixels
               exact, launches F, G, C, U and, fused, P, D), the masked
               latents kernel path against plain path in both;
               scripts.build_dataset.main on a synthetic video (extract,
               dedup, mask with YOLOv7, inpaint, align; each inpainted
               frame equal to its keyframe outside its mask; the caption
               stage is not run, and a line says so); and
               utils/profiling's trace of one annotated inpainting step,
               a StepTimer over 5 steps, and the device's idle share of
               the default configuration's 25-step call, traced;
  quality      the evaluation layer (evaluation/, the port's CLIP vision
               tower and CLIPModel) and the quality scripts, called in
               process through their main(argv) from the checkpoint
               phase's folder with the cli phase's tokenizer, on a
               make_synth_storysalon tree of 512 px frames (4 training
               windows, one held-out story of 4 frames: one window):
               run_chain (stage 1 for 1 step, precompute, stage 2 for 2
               steps with a state every step, from copies of
               configs/stage{1,2}_tpu_smoke.yml that name the folder and
               its tokenizer, at batch 4 x 2 micro-steps; the suite's
               DDIM-40 and dpm++-25 passes at states 1 and 2 with a seeded
               ViT-B/32 scorer written by run_quality.ensure_clip;
               chain.json); run_quality --skip_train --ckpt_step 2;
               compare_quality on the suite's exact and dpm++-25 /
               interval-2 JSONs; inference_coco_val with PickScore (2
               candidates, DDIM-4) whose pick is the argmax of
               PickScorer.score on the same candidates; study_knobs at full
               width; and the scorer on the card against the CPU on the
               generated PNGs (SCORER_IMAGE_REL_L2 with cuDNN's TF32
               default, SCORER_TEXT_REL_L2), its ms per image at batch 1
               and 8; each step's wall time, launches and the JSONs' keys;
  studies      the attention studies' kernels (S1-S4, csrc/study_*.cu, all
               on kernel F's wgmma + TMA template; S3 and S4 with int8
               wgmma): drives every ported study entry point
               (storygen_tpu_torch/studies/) at one of its own UNet shapes,
               checking that it launched each of the eleven study wrappers
               and kernel F (its baseline) and nothing else; prints the
               registers and spill bytes ptxas gave every S1-S4
               instantiation of this run's build (any spill fails the
               phase, and so does a wgmma that ptxas serialises), the
               count of int-to-float conversions and exp2s in S4's SASS,
               and kernel F's time at each study shape, its
               mean and its device time alone; then holds each wrapper's
               instantiations against its plain version on the same
               inputs at the studies' full-width shapes (attn3 L1, attn1
               L1, attn3 L2, attn3 L3), with kernel, plain, library (SDPA,
               for the functions that compute attention), bound (with the
               exps where the kind computes them) and F times, the
               kernel's own device time without its wrapper's host
               preparation (torch.profiler) and its factor over F's,
               beside S3 the bf16 q k^T product alone (torch.bmm, a
               yardstick); and at attn3 L1 and attn1 L1 one line of the
               ablation split (QK, QK_EXP, QK_PV and TB at 128 / 128, each
               alone as a share of F alone). The earlier paths launch no
               study kernel.
  parallel     storygen_tpu_torch/parallel/ on the one card: (a)
               scripts.train.main on stage 2 from the checkpoint folder
               and the cli tree, 2 micro-steps, with --coordinator
               127.0.0.1:<free port> --num_processes 1 --process_id 0
               (NCCL at world size 1) and without, in turns: losses and
               attn3 tensors equal bit for bit; (b) two spawned ranks on
               the card over gloo with the UNet sharded over them (TP =
               2): a 2-frame DDIM-4 512 px story and one fused-conv
               image-cycle pass against one process (rel L2 within
               MODEL_REL_L2), the all-reduces of a reference and a main
               pass against the layout (70 and 86), each rank's launches,
               and F, G, C and P at the shard shapes against their plain
               versions; (c) two ranks, DP = 2, stage-2 micro-steps at
               batch 2 each against one process at batch 4 (losses, grad
               norms and attn3 updates within GRAD_REL_L2). The ranks'
               times are of two processes time-sliced on one card;

There is no CPU branch: without a CUDA device the script exits non-zero
before printing any result. The last line is the JSON status object.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# DDIM steps per story frame: a fifth of the product's 50. Every step runs
# the same kernels at the same shapes, so fewer steps cut time, not coverage.
STORY_STEPS = 10

# Kernel outputs are bf16 (lse fp32); the oracle is the plain version in
# fp32 on the same bf16 inputs. Output rounding alone is 2^-9 relative, and
# each kernel rounds one operand to bf16 inside (P in attention and in dV,
# dS in dQ and dK, the gated product in GEGLU); 1e-2 of the largest
# reference magnitude leaves a 4-5x margin.
KERNEL_RTOL = 1e-2
# Whole-model kernel path vs plain path, both bf16 end to end: the two
# differ by bf16 rounding at every site of ~70 UNet (~30 VAE) layers; a
# wrong kernel gives O(1). Bound on the relative L2 error of the output,
# and of the stage-2 loss.
MODEL_REL_L2 = 5e-2
# The stage-2 attn3 gradients, kernel path vs plain path: the backward runs
# through as many bf16 sites again, so the bound is twice the forward's;
# it holds for the gradient of every attn3 tensor, so a wrong backward at
# any one level (d40, d80 or d160) fails it.
GRAD_REL_L2 = 1e-1

# Kernel P against kernel C on P's prologue applied beforehand: both run
# the same tap loop on the same bf16 slab, so they differ only where the
# prologue's fp32 arithmetic (expf, the division) rounds one activation to
# the neighbouring bf16 value, which moves an output by about 2^-8 of one
# tap's term; 1e-3 of the largest output magnitude bounds a few such flips.
P_VS_C_RTOL = 1e-3

# The H100 SXM's dense bf16 tensor-core rate and HBM rate (NVIDIA's data
# sheet), for each kernel's bound; int8 tensor-core work runs at twice the
# bf16 rate (1,979 TOPS dense).
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
# The special-function units' ex2 rate: 16 a clock per SM on 132 SMs at the
# 1.83 GHz that 989 TFLOP/s implies (989e12 / (132 x 4096 operations a
# clock)): the attention kernels' third bound, one exp per kept logit.
PEAK_EXPS = 132 * 16 * 1.83e9
# The int8 study's column sum: exact int32 sums per K/V tile, accumulated
# in fp32 across tiles, against the exact (float64) plain sum; at attn3 L1
# its rounding is about 1e-7 of the largest sum.
INT8_SUM_RTOL = 1e-6

# attn3's per-batch keep table over its 3 reference spans (newest last)
KEEP = [[0, 0, 1], [0, 1, 1], [1, 1, 1], [0, 0, 1]]
# a table whose first row keeps no span (never drawn in training)
NONE_KEPT = [[0, 0, 0], [0, 1, 1]]

KERNEL_META = {
    "flash_fwd": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:124"},
    "flash_fwd_masked": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:157"},
    "flash_lse": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:526"},
    "flash_dq": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:558"},
    "flash_dkv": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:593"},
    "geglu_matmul": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/geglu_matmul.cu",
        "replaces": "storygen_tpu/ops/pallas_geglu.py:50"},
    "conv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/conv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:61"},
    # _kernel with fused=True, its pallas_call at :295 via gnconv3x3 :527
    "gnconv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/conv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:61"},
    "downconv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/downconv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:312"},
    # an XLA module, not a pallas_call: _UpsampleConv, the JAX package's
    # 2x upsample + 3x3 conv as four phase convs on the source grid
    "upconv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/upconv3x3.cu",
        "replaces": "storygen_tpu/models/layers.py:220"},
    # U's input gradient: XLA's gradient of _UpsampleConv's phase convs
    # (:265-267), no pallas_call either
    "upconv3x3_dx": {
        "route": "cuda",
        "source": "storygen_tpu_torch/csrc/upconv_dx3x3.cu",
        "replaces": "storygen_tpu/models/layers.py:265"},
}
# the serving and training paths' eleven kernels
PORT_KERNELS = tuple(KERNEL_META)
# the kernels whose rate the kernels phase prints, with the library call
# that their factor is taken over (None: DQ and DKV, whose sum is held
# against SDPA's backward alone)
RATED = {"flash_fwd": "SDPA", "flash_fwd_masked": "SDPA",
         "flash_lse": "SDPA's call that returns lse",
         "flash_dq": None, "flash_dkv": None,
         "conv3x3": "cuDNN", "gnconv3x3": "cuDNN", "downconv3x3": "cuDNN",
         "upconv3x3": "cuDNN's transposed conv",
         "upconv3x3_dx": "cuDNN's 4x4 stride-2 conv"}
STUDY_SOURCES = {"online": "storygen_tpu_torch/csrc/study_online.cu",
                 "bounded": "storygen_tpu_torch/csrc/study_bounded.cu",
                 "bnd2": "storygen_tpu_torch/csrc/study_bnd2.cu",
                 "qk": "storygen_tpu_torch/csrc/study_qk.cu",
                 "int8": "storygen_tpu_torch/csrc/study_int8.cu"}
# each study wrapper: its kernel's source and the Pallas kernel it replaces
for _name, _src, _line in (
        ("variant_attention", "online", "bench_attn_variants.py:40"),
        ("t_attention", "online", "bench_attn_v2.py:51"),
        ("tb_attention", "bounded", "bench_attn_v2.py:112"),
        ("bounded_attention", "bounded", "bench_attn_scan.py:110"),
        ("bounded_multi_attention", "bounded", "bench_attn_scan.py:204"),
        ("ablate_attention", "bounded", "bench_attn_ablate.py:37"),
        ("bnd2_attention", "bnd2", "bench_attn_bnd2.py:31"),
        ("mh_attention", "bnd2", "bench_attn_multihead.py:30"),
        ("qk_only", "qk", "bench_attn_int8.py:48"),
        ("full_int8", "int8", "bench_attn_int8.py:90"),
        # the same _full_int8_kernel, its pallas_call in the epilogue study
        ("int8_attn_from_quant", "int8", "bench_attn_int8_epilogue.py:86")):
    KERNEL_META[_name] = {"route": "cuda", "source": STUDY_SOURCES[_src],
                          "replaces": f"scripts/studies/{_line}",
                          "design": "wgmma + TMA"}
STUDY_KERNELS = tuple(k for k in KERNEL_META if k not in PORT_KERNELS)
# the CUDA kernel that each study source launches (its name in a trace)
STUDY_ENTRIES = {STUDY_SOURCES["online"]: "online_wg_kernel",
                 STUDY_SOURCES["bounded"]: "bounded_wg_kernel",
                 STUDY_SOURCES["bnd2"]: "bounded_wg_kernel",
                 STUDY_SOURCES["qk"]: "qk_wg_kernel",
                 STUDY_SOURCES["int8"]: "int8_wg_kernel"}
SERVING_KERNELS = ("flash_fwd", "geglu_matmul", "conv3x3", "upconv3x3")
FUSED_KERNELS = ("gnconv3x3", "downconv3x3")
# what each path must launch (> 0); every other kernel is held to 0 (the
# study kernels on every serving and training path)
PATH_KERNELS = {
    "story": SERVING_KERNELS,
    "train": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS),
    "story_fused": SERVING_KERNELS + FUSED_KERNELS,
    # the serving phase's runs: every sampler, stage "multi-image-condition"
    # in both configurations, and generate_story(fused=True)
    "samplers": SERVING_KERNELS,
    "mic": SERVING_KERNELS,
    "mic_fused": SERVING_KERNELS + FUSED_KERNELS,
    "rollout": SERVING_KERNELS,
    "train_fused": PORT_KERNELS,
    # the story from a loaded folder; stage 1 (attn1) and COCO (attn3
    # without a mask) train without M; stage 2 on precomputed latents,
    # with its validation render
    "checkpoint": SERVING_KERNELS,
    "train_stage1": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS
                          and k != "flash_fwd_masked"),
    "train_coco": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS
                        and k != "flash_fwd_masked"),
    "train_precomputed": tuple(k for k in PORT_KERNELS
                               if k not in FUSED_KERNELS),
    # the cli phase: the VAE encoder alone (kernel C); stage 2 from images
    # and from latents; a story and a served request
    "cli_precompute": ("conv3x3",),
    "cli_train": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS),
    "cli_train_latents": tuple(k for k in PORT_KERNELS
                               if k not in FUSED_KERNELS),
    "cli_inference": SERVING_KERNELS,
    "cli_serve": SERVING_KERNELS,
    # the dataset phase: inpainting (the UNet and the VAE) in both conv
    # configurations, and build_dataset's stages (YOLOv7 is F.conv2d)
    "inpaint": SERVING_KERNELS,
    "inpaint_fused": SERVING_KERNELS + FUSED_KERNELS,
    "dataset_build": SERVING_KERNELS,
    # the parallel phase: training over NCCL at world size 1; per rank,
    # the TP = 2 story, the fused TP image-cycle pass and DP = 2 training
    "nccl_train": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS),
    **{f"{p}_r{r}": ks for r in (0, 1) for p, ks in (
        ("tp_story", SERVING_KERNELS),
        ("tp_fused_pass", SERVING_KERNELS + FUSED_KERNELS),
        ("dp_train", tuple(k for k in PORT_KERNELS
                           if k not in FUSED_KERNELS)))},
    # the study entry points, with kernel F as their baseline
    "studies": STUDY_KERNELS + ("flash_fwd",),
    # the story from the offline export's folder (train_more)
    "export": SERVING_KERNELS,
}
# kernel C's launches on each training path while U's input gradient ran
# on C over the 2x grid (commit 1cc6792's run of this script): kernel UB
# takes exactly those launches, so C's and UB's launches add up to them
C_LAUNCHES_BEFORE_UB = {
    "train": 1356, "train_fused": 108, "train_stage1": 316,
    "train_coco": 452, "train_precomputed": 1008, "cli_train": 452,
    "cli_train_latents": 386, "nccl_train": 452, "dp_train_r0": 452,
    "dp_train_r1": 452, "quality_chain": 14768}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    """Every kernel's wrapper, whose `.launches` counts its launches."""
    from storygen_tpu_torch.ops import (conv, downconv, flash_attention as fa,
                                        geglu, study_attention, study_int8,
                                        upconv)
    out = {"flash_fwd": fa.flash_fwd, "flash_fwd_masked": fa.flash_fwd_masked,
           "flash_lse": fa.flash_lse, "flash_dq": fa.flash_dq,
           "flash_dkv": fa.flash_dkv, "geglu_matmul": geglu.geglu_matmul,
           "conv3x3": conv.conv3x3, "gnconv3x3": conv.gnconv3x3,
           "downconv3x3": downconv.downconv3x3,
           "upconv3x3": upconv.upconv3x3,
           "upconv3x3_dx": upconv.upconv3x3_dx}
    for w in study_attention.WRAPPERS + study_int8.WRAPPERS:
        out[w.__name__] = w
    return out


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


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


def device_ms(fn, kernel: str, iters: int = 5):
    """Device time per call of the CUDA kernels whose name holds `kernel`,
    from a torch.profiler trace of `iters` calls after one warm-up: a
    kernel's own time, without its wrapper's host preparation. Each kernel
    name counts its mean per launch that the trace kept, times its
    launches a call (a trace late in a long process has lost some of a
    kernel's launches, which a sum over `iters` calls read as a shorter
    kernel); None if three traces in turn hold no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost its kernels is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_call = sum(
            e.device_time_total / e.count * max(1, round(e.count / iters))
            for e in prof.key_averages()
            if kernel in e.key and e.count
            and getattr(e, "device_time_total", 0.0))
        if per_call:
            return per_call / 1e3
    return None


def kernels_ms(fn, iters: int = 5):
    """Device time per call of every kernel and copy that `fn` runs on the
    card, from a torch.profiler trace of `iters` calls after one warm-up:
    a path of several PyTorch calls without its host's pace; None if the
    trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3 if us else None


def bound_ms(flops: float, nbytes: float, exps: float = 0.0):
    """The least time for the work, max(flops / 989e12, bytes / 3.35e12,
    exps / PEAK_EXPS): (ms, the binding term: "operations", "bytes" or
    "exps"). Exps are operations of the special-function units; the
    status line's bound_by names them "operations"."""
    terms = {"operations": flops / PEAK_FLOPS, "bytes": nbytes / PEAK_BYTES,
             "exps": exps / PEAK_EXPS}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by


def host_us(fn, iters: int = 50) -> float:
    """Host microseconds per call of `fn` with the device's queue not full:
    what the call costs the CPU (enqueue, not device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


def flash_alone(q, k, v, h, scale, keep=None):
    """Kernel F's (M's, with `keep`) C launcher on this call's operands,
    its output and int32 keep table made once, as a callable."""
    import torch
    from storygen_tpu_torch.ops import _build
    b, sq, hd = q.shape
    skv = k.shape[1]
    nref = 1 if keep is None else keep.shape[1]
    keep32 = None if keep is None else keep.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            sq, skv, hd // h, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1),
            None if keep32 is None else keep32.data_ptr(), nref,
            skv // nref, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.load().sg_flash_fwd

    def call(held=(out, keep32)):
        _build.check(fn(*args), "sg_flash_fwd")
    return call


def bwd_alone(kernel, q, k, v, dout, lse, delta, h, scale, keep=None):
    """Kernel DQ's (`kernel` "dq") or DKV's C launcher on this call's
    operands, its outputs and int32 keep table made once, as a
    callable."""
    import torch
    from storygen_tpu_torch.ops import _build
    b, sq, hd = q.shape
    skv = k.shape[1]
    nref = 1 if keep is None else keep.shape[1]
    keep32 = None if keep is None else keep.to(torch.int32).contiguous()
    outs = ([torch.empty(q.shape, dtype=q.dtype, device=q.device)]
            if kernel == "dq" else
            [torch.empty((b, skv, hd), dtype=k.dtype, device=k.device)
             for _ in range(2)])
    name = f"sg_flash_{kernel}"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, h, sq, skv, hd // h, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1),
            None if keep32 is None else keep32.data_ptr(), nref,
            skv // nref, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    fn = getattr(_build.load(), name)

    def call(held=(outs, keep32)):
        _build.check(fn(*args), name)
    return call


def conv_alone(x, w9, bias, residual, *affine):
    """Kernel C's (P's, with fp32 a and s) C launcher on this call's
    operands, its output and split workspace made once, as a callable."""
    import torch
    from storygen_tpu_torch.ops import _build, conv
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    name = "sg_gnconv3x3" if affine else "sg_conv3x3"
    shape = conv.workspace_shape(bool(affine), b, h, w, cin, cout)
    keep = [bias.float().contiguous(), *(t.float().contiguous()
                                         for t in affine),
            torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)]
    if shape is not None:
        keep.append(torch.empty(shape, dtype=torch.float32, device=x.device))
    args = (x.data_ptr(), w9.data_ptr(), keep[0].data_ptr(),
            cout if bias.dim() == 2 else 0,
            *(t.data_ptr() for t in keep[1:1 + len(affine)]),
            None if residual is None else residual.data_ptr(),
            keep[1 + len(affine)].data_ptr(),
            None if shape is None else keep[-1].data_ptr(),
            1 if shape is None else shape[0], b, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    fn = getattr(_build.load(), name)

    def call(keep=keep):
        _build.check(fn(*args), name)
    return call


def lse_alone(q, k, h, scale, keep=None):
    """Kernel L's C launcher on this call's operands, its output and int32
    keep table made once, as a callable."""
    import torch
    from storygen_tpu_torch.ops import _build
    b, sq, hd = q.shape
    skv = k.shape[1]
    nref = 1 if keep is None else keep.shape[1]
    keep32 = None if keep is None else keep.to(torch.int32).contiguous()
    out = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), out.data_ptr(), b, h, sq, skv,
            hd // h, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            None if keep32 is None else keep32.data_ptr(), nref, skv // nref,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    fn = _build.load().sg_flash_lse

    def call(held=(out, keep32)):
        _build.check(fn(*args), "sg_flash_lse")
    return call


def down_alone(x, w9, bias, pad):
    """Kernel D's C launcher on this call's operands (Cout a multiple of 8,
    W >= 2), its output and split workspace made once, as a callable."""
    import torch
    from storygen_tpu_torch.ops import _build, conv, downconv
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    ho, wo = downconv.out_size(h, w, pad)
    shape = conv.workspace_shape(False, b, ho, wo, cin, cout,
                                 downconv.down_tile(cin, cout, wo))
    keep = [bias.float().contiguous(),
            torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)]
    if shape is not None:
        keep.append(torch.empty(shape, dtype=torch.float32, device=x.device))
    args = (x.data_ptr(), w9.data_ptr(), keep[0].data_ptr(),
            keep[1].data_ptr(), None if shape is None else keep[2].data_ptr(),
            1 if shape is None else shape[0], b, h, w, cin, cout, ho, wo,
            int(pad[0]), int(pad[2]),
            torch.cuda.current_stream(x.device).cuda_stream)
    fn = _build.load().sg_downconv3x3

    def call(keep=keep):
        _build.check(fn(*args), "sg_downconv3x3")
    return call


def up_alone(x, w16, bias):
    """Kernel U's C launcher on this call's operands, its output and split
    workspace made once, as a callable."""
    import torch
    from storygen_tpu_torch.ops import _build, upconv
    b, h, w, cin = x.shape
    cout = w16.shape[2]
    shape = upconv.workspace_shape(b, h, w, cin, cout)
    keep = [bias.float().contiguous(),
            torch.empty((b, 2 * h, 2 * w, cout), dtype=x.dtype,
                        device=x.device)]
    if shape is not None:
        keep.append(torch.empty(shape, dtype=torch.float32, device=x.device))
    args = (x.data_ptr(), w16.data_ptr(), keep[0].data_ptr(),
            keep[1].data_ptr(), None if shape is None else keep[2].data_ptr(),
            1 if shape is None else shape[0], b, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    fn = _build.load().sg_upconv3x3

    def call(keep=keep):
        _build.check(fn(*args), "sg_upconv3x3")
    return call


def ub_alone(g, k16):
    """Kernel UB's C launcher on a cotangent and the packed weights
    (`upconv.dx_weight`), its output and split workspace made once, as a
    callable."""
    import torch
    from storygen_tpu_torch.ops import _build, upconv
    b, h2, w2, cin = g.shape
    h, w, cout = h2 // 2, w2 // 2, k16.shape[2]
    splits = upconv.dx_splits(cin, cout, h, w)
    keep = [torch.empty((b, h, w, cout), dtype=g.dtype, device=g.device)]
    if splits > 1:
        keep.append(torch.empty((splits, b * h * w, cout),
                                dtype=torch.float32, device=g.device))
    args = (g.data_ptr(), k16.data_ptr(), keep[0].data_ptr(),
            keep[1].data_ptr() if splits > 1 else None, splits, b, h, w, cin,
            cout, torch.cuda.current_stream(g.device).cuda_stream)
    fn = _build.load().sg_upconv_dx3x3

    def call(keep=keep):
        _build.check(fn(*args), "sg_upconv_dx3x3")
    return call


def parent_dx(g, w9):
    """U's input gradient as the port computed it before kernel UB: kernel
    C on the flipped 3x3 weight over the 2x grid, then each source pixel's
    2x2 copies summed in fp32 (a yardstick; no port path runs it)."""
    import torch
    from storygen_tpu_torch.ops import conv
    b, h2, w2, _ = g.shape
    cin = w9.shape[1]
    zero = torch.zeros(cin, dtype=torch.float32, device=g.device)
    dup = conv.conv3x3(g, conv.flip_weight(w9), zero)
    return dup.float().reshape(b, h2 // 2, 2, w2 // 2, 2, cin).sum(
        (2, 4)).to(g.dtype)


def transposed_weight(w16):
    """Kernel U's (16, Cin, Cout) phase weights as the (Cin, Cout, 4, 4)
    weight of F.conv_transpose2d(x, ., stride=2, padding=1), the one
    PyTorch call that computes U's function: output row 2y + a takes
    source row y - 1 + a + r through its kernel row 3 - a - 2r (columns
    alike), which is phase a's tap r."""
    cin, cout = w16.shape[1:]
    k = w16.new_empty((cin, cout, 4, 4))
    for ph in range(4):
        a, b = divmod(ph, 2)
        for tap in range(4):
            r, c = divmod(tap, 2)
            k[:, :, 3 - a - 2 * r, 3 - b - 2 * c] = w16[4 * ph + tap]
    return k


def geglu_alone(proj, w, bias, tokens):
    """Kernel G's C launcher on this call's operands and its output made
    once, as a callable."""
    import torch
    from storygen_tpu_torch.ops import _build
    m, (e, n) = proj.shape[0], w.shape
    out = torch.empty((m, e), dtype=proj.dtype, device=proj.device)
    args = (proj.data_ptr(), w.data_ptr(), bias.data_ptr(),
            int(bias.dtype == torch.float32), out.data_ptr(), m, n, e, tokens,
            torch.cuda.current_stream(proj.device).cuda_stream)
    fn = _build.load().sg_geglu_matmul

    def call(out=out):
        _build.check(fn(*args), "sg_geglu_matmul")
    return call


class Case:
    """One kernel at one shape: the kernel call, its plain version on the
    same bf16 inputs, the fp32 oracle, an optional library call, and the
    operations and bytes the function needs (unpadded shapes, kept spans
    only, each input read once and each output written once). `twin`, if
    given, is a second reference that the kernel must match within
    P_VS_C_RTOL (kernel C on P's prologue applied beforehand).
    `backward`, for DQ and DKV, makes SDPA's backward alone on the case's
    inputs: it runs SDPA's forward once and returns the call to time.
    `unfused`, for G, is the bf16 chain of PyTorch calls without the
    kernel: timed as a yardstick, it is not G's function (it rounds the
    gated product where PyTorch does). `yardstick`, for S3, is the bf16
    q k^T product alone (torch.bmm): S3 has no one-call equivalent, and
    the product is not S3's function (it writes the logits, S3 their
    sums). `yardsticks`, for U, names PyTorch paths to the same output
    timed beside it, mean and device time alone (the parent's upsampling
    copies and kernel C on the 2x grid; F.interpolate and cuDNN's conv2d).
    `alone`, for C, P, F, M, DQ, DKV, G and U, is the kernel's C launcher
    on operands and buffers made once: the host's cost of a call without
    the wrapper's checks and allocations; `device` names the CUDA kernels whose
    device time alone is read from a trace. `exps`, for the attention
    kernels, is the exponentials the function needs (one per kept logit),
    the bound's third term. `repeat`, for DQ and DKV, runs the kernel a
    second time and requires the two results equal bit for bit."""

    def __init__(self, name, label, kern, plain, oracle, library, flops,
                 nbytes, twin=None, backward=None, unfused=None,
                 yardstick=None, alone=None, device="sg_conv::", exps=0.0,
                 repeat=False, yardsticks=None):
        self.name, self.label = name, label
        self.kern, self.plain, self.oracle = kern, plain, oracle
        self.library, self.flops, self.nbytes = library, flops, nbytes
        self.twin, self.backward = twin, backward
        self.unfused = unfused
        self.yardstick = yardstick
        self.alone = alone
        self.device, self.exps = device, exps
        self.repeat = repeat
        self.yardsticks = yardsticks or {}


def _attn_cases(dev, rnd):
    """F and M forward cases, and the L/DQ/DKV backward cases."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import flash_attention as fa
    from storygen_tpu_torch.ops.flash_attention import split_heads

    def sdpa_mask(keep, skv):
        return None if keep is None else fa.keep_to_mask(keep, skv)

    def kept_rows(keep, b, skv):
        if keep is None:
            return b * skv
        return int(keep.sum().item()) * (skv // keep.shape[1])

    cases = []
    fwd = [("attn1 L1", 6, 4096, 4096, 40, None),
           # the main pass's attn1 (3-row CFG batch), 5 launches per pass
           ("attn1 L1", 3, 4096, 4096, 40, None),
           ("attn3 L1", 3, 4096, 12288, 40, None),
           ("attn3 L2", 3, 1024, 3072, 80, None),
           ("attn3 L3", 3, 256, 768, 160, None),
           ("attn1 mid", 6, 64, 64, 160, None),
           ("attn2 L1", 3, 4096, 77, 40, None),
           ("ragged", 2, 1000, 333, 40, None),
           ("masked attn3 L1", 4, 4096, 12288, 40, KEEP),
           ("masked attn3 L2", 4, 1024, 3072, 80, KEEP),
           ("masked attn3 L3", 4, 256, 768, 160, KEEP),
           ("masked attn3 mid", 4, 64, 192, 160, KEEP),
           # spans that straddle the 64-row K/V tiles: the mid block at
           # 256 px (span 16) and at 768 px (span 144)
           ("masked attn3 mid 256px", 4, 16, 48, 160, KEEP),
           ("masked attn3 mid 768px", 4, 144, 432, 160, KEEP),
           # a row that keeps no ref: output 0, as the plain version's
           ("masked none kept", 2, 256, 768, 80, NONE_KEPT),
           # a tensor-parallel rank's heads at tp = 2 (parallel phase)
           # and tp = 4
           ("attn1 L1 TP=2 shard, 4 heads", 3, 4096, 4096, 40, None, 4),
           ("attn1 L1 TP=4 shard, 2 heads", 3, 4096, 4096, 40, None, 2),
           # k and v as the two halves of one (B, Skv, 2 H D) tensor
           # (kv.chunk(2, -1)): row strides of 2 H D, read without a copy
           ("attn1 L1 k|v split view", 3, 4096, 4096, 40, None, 8, True),
           ("masked attn3 L2 k|v split view", 4, 1024, 3072, 80, KEEP, 8,
            True)]
    for label, b, sq, skv, d, table, *rest in fwd:
        h = rest[0] if rest else 8
        q = rnd(b, sq, h * d)
        if len(rest) > 1 and rest[1]:
            k, v = rnd(b, skv, 2 * h * d).chunk(2, -1)
        else:
            k, v = rnd(b, skv, h * d), rnd(b, skv, h * d)
        sc = d ** -0.5
        masked = table is not None
        keep = (torch.tensor(table, dtype=torch.bool, device=dev)
                if masked else None)
        rows = kept_rows(keep, b, skv)
        flops = 4.0 * h * sq * rows * d
        nbytes = 2.0 * h * d * (2 * b * sq + 2 * rows)
        mask = sdpa_mask(keep, skv)
        name = "flash_fwd_masked" if masked else "flash_fwd"
        kern = ((lambda q=q, k=k, v=v, sc=sc, keep=keep, h=h:
                 fa.flash_fwd_masked(q, k, v, h, sc, keep)) if masked else
                (lambda q=q, k=k, v=v, sc=sc, h=h: fa.flash_fwd(q, k, v, h,
                                                              sc)))
        cases.append(Case(
            name, f"{label} B{b} {sq}x{skv} d{d}", kern,
            lambda q=q, k=k, v=v, sc=sc, keep=keep, h=h:
                fa.flash_attention_plain(q, k, v, h, sc, keep),
            lambda q=q, k=k, v=v, sc=sc, keep=keep, h=h:
                fa.flash_attention_plain(q.float(), k.float(), v.float(), h,
                                         sc, keep),
            lambda q=q, k=k, v=v, sc=sc, mask=mask, h=h:
                F.scaled_dot_product_attention(
                    split_heads(q, h), split_heads(k, h), split_heads(v, h),
                    attn_mask=mask, scale=sc),
            flops, nbytes, alone=flash_alone(q, k, v, h, sc, keep),
            device="flash_", exps=float(h * sq * rows)))

    bwd = [("attn1 L1", 4, 4096, 4096, 40, None),
           ("masked attn3 L1", 4, 4096, 12288, 40, KEEP),
           ("attn2 L1", 4, 4096, 77, 40, None),
           # the training path's d 80 sites
           ("attn1 L2", 4, 1024, 1024, 80, None),
           ("masked attn3 L2", 4, 1024, 3072, 80, KEEP),
           ("masked attn3 L3", 4, 256, 768, 160, KEEP),
           ("attn1 mid", 4, 64, 64, 160, None),
           ("masked attn3 mid 256px", 4, 16, 48, 160, KEEP),
           ("masked attn3 mid 768px", 4, 144, 432, 160, KEEP),
           ("masked none kept", 2, 256, 768, 80, NONE_KEPT),
           # Sq and Skv that no tile divides: the last Q and K/V tiles of
           # DQ and DKV are partial on both sides
           ("ragged", 2, 1000, 333, 40, None),
           ("ragged", 2, 1000, 333, 160, None),
           # an Sq whose fp32 rows are not 16-byte aligned: DKV's lse and
           # delta by the producer's plain loads instead of TMA
           ("odd Sq", 2, 999, 333, 40, None),
           # k and v as the two halves of one (B, Skv, 2 H D) tensor
           ("masked attn3 L2 k|v split view", 4, 1024, 3072, 80, KEEP, 8,
            True),
           # a tensor-parallel rank's heads at tp = 2 (a TP training step)
           ("attn1 L1 TP=2 shard, 4 heads", 4, 4096, 4096, 40, None, 4),
           ("masked attn3 L1 TP=2 shard, 4 heads", 4, 4096, 12288, 40, KEEP,
            4)]
    for label, b, sq, skv, d, table, *rest in bwd:
        h = rest[0] if rest else 8
        q = rnd(b, sq, h * d)
        if len(rest) > 1 and rest[1]:
            k, v = rnd(b, skv, 2 * h * d).chunk(2, -1)
        else:
            k, v = rnd(b, skv, h * d), rnd(b, skv, h * d)
        dout = rnd(b, sq, h * d)
        sc = d ** -0.5
        keep = (torch.tensor(table, dtype=torch.bool, device=dev)
                if table is not None else None)
        rows = kept_rows(keep, b, skv)
        with torch.no_grad():
            out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           h, sc, keep).to(q.dtype)
            delta = fa.attention_delta(out, dout, h)
            lse = fa.flash_lse_plain(q.float(), k.float(), h, sc, keep)
        mask = sdpa_mask(keep, skv)

        def sdpa_fwd_bwd(h=h, q=q, k=k, v=v, dout=dout, sc=sc, mask=mask):
            qh, kh, vh = (split_heads(t, h).detach().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               scale=sc)
            o.backward(split_heads(dout, h))

        def lse_library(h=h, q=q, k=k, v=v, sc=sc, keep=keep, skv=skv):
            """One PyTorch call that returns the row logsumexp (and
            computes O too): SDPA's flash kernel, or with a keep mask its
            memory-efficient kernel on the mask as an additive bias."""
            qh, kh, vh = (split_heads(t, h) for t in (q, k, v))
            if keep is None:
                return torch.ops.aten._scaled_dot_product_flash_attention(
                    qh, kh, vh, scale=sc)[1]
            bias = torch.zeros(keep.shape[0], 1, 1, skv, dtype=q.dtype,
                               device=q.device).masked_fill(
                ~fa.keep_to_mask(keep, skv), float("-inf"))
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, bias.expand(-1, h, qh.shape[2], -1), True,
                scale=sc)[1]

        def sdpa_bwd(h=h, q=q, k=k, v=v, dout=dout, sc=sc, mask=mask):
            qh, kh, vh = (split_heads(t, h).detach().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               scale=sc)
            g = split_heads(dout, h)
            return lambda: torch.autograd.grad(o, (qh, kh, vh), g,
                                               retain_graph=True)

        tag = f"{label} B{b} {sq}x{skv} d{d}"
        qb, kvb = 2.0 * b * sq * h * d, 2.0 * rows * h * d  # bf16 bytes
        kv_out = 2.0 * b * skv * h * d  # dK or dV, every row written
        rowb = 4.0 * b * h * sq  # an fp32 (B, H, Sq) row of scalars
        mm = 2.0 * h * sq * rows * d  # one (Sq x kept Skv x D) product
        logits = float(h * sq * rows)  # one exp each in L, DQ and DKV
        args = (q, k, v, dout, lse, delta)
        f32 = tuple(t.float() for t in (q, k, v, dout)) + (lse, delta)
        cases += [
            Case("flash_lse", tag,
                 lambda h=h, q=q, k=k, sc=sc, keep=keep: fa.flash_lse(
                     q, k, h, sc, keep),
                 lambda h=h, q=q, k=k, sc=sc, keep=keep: fa.flash_lse_plain(
                     q, k, h, sc, keep),
                 lambda lse=lse: lse, lse_library, mm, qb + kvb + rowb,
                 exps=logits, alone=lse_alone(q, k, h, sc, keep),
                 device="lse_wg_kernel"),
            Case("flash_dq", tag,
                 lambda h=h, a=args, sc=sc, keep=keep: fa.flash_dq(
                     *a, h, sc, keep),
                 lambda h=h, a=args, sc=sc, keep=keep: fa.flash_dq_plain(
                     *a, h, sc, keep),
                 lambda h=h, a=f32, sc=sc, keep=keep: fa.flash_dq_plain(
                     *a, h, sc, keep),
                 sdpa_fwd_bwd, 3 * mm, 3 * qb + 2 * kvb + 2 * rowb,
                 backward=sdpa_bwd, exps=logits,
                 alone=bwd_alone("dq", *args, h, sc, keep), device="flash_",
                 repeat=True),
            Case("flash_dkv", tag,
                 lambda h=h, a=args, sc=sc, keep=keep: fa.flash_dkv(
                     *a, h, sc, keep),
                 lambda h=h, a=args, sc=sc, keep=keep: fa.flash_dkv_plain(
                     *a, h, sc, keep),
                 lambda h=h, a=f32, sc=sc, keep=keep: fa.flash_dkv_plain(
                     *a, h, sc, keep),
                 sdpa_fwd_bwd, 4 * mm,
                 2 * qb + 2 * kvb + 2 * kv_out + 2 * rowb,
                 backward=sdpa_bwd, exps=logits,
                 alone=bwd_alone("dkv", *args, h, sc, keep), device="flash_",
                 repeat=True)]
    return cases


def kernel_cases(dev):
    """Every kernel at the main paths' 512 px shapes."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import conv, geglu

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(
            torch.bfloat16)

    cases = _attn_cases(dev, rnd)
    # every feed-forward site class: the serving main pass (3-row CFG
    # batch), its reference pass (6 rows), stage-2 training (batch 4); an
    # fp32 bias (the kernel reads either dtype as stored) and a ragged M
    # under a split of N (4 images of 250 rows)
    for label, m, n, e, tokens, bias32 in [
            ("L1 ff", 3 * 4096, 1280, 320, 4096, False),
            ("L2 ff", 3 * 1024, 2560, 640, 1024, False),
            ("L3 ff", 3 * 256, 5120, 1280, 256, False),
            ("mid ff", 192, 5120, 1280, 64, False),
            ("L1 ref ff", 6 * 4096, 1280, 320, 4096, False),
            ("L2 ref ff", 6 * 1024, 2560, 640, 1024, False),
            ("L1 train ff", 4 * 4096, 1280, 320, 4096, False),
            ("mid train ff", 4 * 64, 5120, 1280, 64, False),
            ("L1 ff fp32 bias", 3 * 4096, 1280, 320, 4096, True),
            ("ragged", 1000, 5120, 1280, 250, False),
            # a tensor-parallel rank's inner shard at tp = 2 and 4, and
            # every level's at tp = 8 (L1's N = 160 takes the K step 32)
            ("L1 ff TP=2 shard", 3 * 4096, 640, 320, 4096, False),
            ("L1 ff TP=4 shard", 3 * 4096, 320, 320, 4096, False),
            ("L1 ff TP=8 shard", 3 * 4096, 160, 320, 4096, False),
            ("L2 ff TP=8 shard", 3 * 1024, 320, 640, 1024, False),
            ("L3 ff TP=8 shard", 3 * 256, 640, 1280, 256, False)]:
        p, w = rnd(m, 2 * n), rnd(e, n, s=n ** -0.5)
        bias = rnd(e).float() if bias32 else rnd(e)
        cases.append(Case(
            "geglu_matmul", f"{label} ({m}, 2x{n})->{e}",
            lambda p=p, w=w, bias=bias, t=tokens: geglu.geglu_matmul(
                p, w, bias, t),
            lambda p=p, w=w, bias=bias: geglu.geglu_matmul_plain(p, w, bias),
            lambda p=p, w=w, bias=bias: geglu.geglu_matmul_plain(
                p.float(), w.float(), bias.float()),
            None, 2.0 * m * n * e,
            2.0 * (2 * m * n + e * n + m * e) + bias.element_size() * e,
            unfused=lambda p=p, w=w, bias=bias: F.linear(
                p[:, :w.shape[1]] * F.gelu(p[:, w.shape[1]:]), w,
                bias.to(p.dtype)), alone=geglu_alone(p, w, bias, tokens),
            device="geglu_wg_kernel"))
    for label, b, hw, cin, cout, bias_b, res in [
            ("UNet up L1 (B,C) bias", 3, 64, 960, 320, True, False),
            ("UNet L1 residual", 3, 64, 320, 320, False, True),
            ("VAE dec 512px", 1, 512, 256, 128, False, False),
            ("VAE enc conv_in", 1, 512, 3, 128, False, False),
            ("VAE dec conv_out", 1, 512, 128, 3, False, False),
            ("UNet conv_in", 3, 64, 4, 320, False, False),
            # the tiles for 16- and 8-column images and the input gradient
            ("UNet L3", 3, 16, 1280, 1280, False, False),
            ("UNet mid", 3, 8, 1280, 1280, False, False),
            ("UNet up block 1", 3, 8, 2560, 1280, False, False),
            ("UNet up L1 input gradient", 3, 64, 320, 960, False, False),
            # a tensor-parallel rank's conv1 and conv2 at tp = 2 and 4
            ("UNet L1 conv1 TP=2 shard (B,C) bias", 3, 64, 320, 160, True,
             False),
            ("UNet L1 conv2 TP=2 shard", 3, 64, 160, 320, False, False),
            ("UNet L1 conv1 TP=4 shard (B,C) bias", 3, 64, 320, 80, True,
             False),
            ("UNet L1 conv2 TP=4 shard", 3, 64, 80, 320, False, False)]:
        x = rnd(b, hw, hw, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                           device=dev)
        r = rnd(b, hw, hw, cout) if res else None
        # the yardstick: cuDNN's channels_last bf16 convolution (with the
        # (Cout) bias; the per-batch bias and the residual are not in it)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_lib = None if bias_b else bias.to(torch.bfloat16)
        pix = b * hw * hw
        cases.append(Case(
            "conv3x3", f"{label} B{b} {hw}x{hw} {cin}->{cout}",
            lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3(x, w9, bias, r),
            lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3_plain(
                x, w9, bias, r),
            lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3_plain(
                x.float(), w9.float(), bias,
                None if r is None else r.float()),
            lambda x=x_cl, w=w_cl, bb=b_lib: F.conv2d(x, w, bb, padding=1),
            2.0 * pix * 9 * cin * cout,
            2.0 * (pix * cin + 9 * cin * cout + pix * cout * (2 if res
                                                               else 1))
            + 4.0 * bias.numel(), alone=conv_alone(x, w9, bias, r)))
    return (cases + _fused_conv_cases(dev, g, rnd) + _up_cases(dev, g, rnd)
            + _ub_cases(dev, g, rnd))


def _fused_conv_cases(dev, g, rnd):
    """P (with and without the residual, (Cout) or (B, Cout) bias) and D
    (pad 1 and the VAE's (0, 1)), each with a ragged case: a width that is
    not a multiple of the 16-column tile."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import conv, downconv
    cases = []
    for label, b, h, w, cin, cout, bias_b, res in [
            ("UNet L1 + residual", 3, 64, 64, 320, 320, False, True),
            ("UNet up L1 (B,C) bias", 3, 64, 64, 960, 320, True, False),
            ("VAE dec 512px + residual", 1, 512, 512, 128, 128, False, True),
            ("VAE enc 512px", 3, 512, 512, 128, 128, False, False),
            # the tiles for 16- and 8-column images
            ("UNet L3 (B,C) bias + residual", 3, 16, 16, 1280, 1280, True,
             True),
            ("UNet mid (B,C) bias + residual", 3, 8, 8, 1280, 1280, True,
             True),
            ("ragged (B,C) bias + residual", 2, 40, 24, 320, 320, True,
             True),
            # a tensor-parallel rank's conv2 at tp = 2 and 4 (16 and 8 of
            # the 32 groups)
            ("UNet L1 conv2 TP=2 shard", 3, 64, 64, 160, 320, False,
             False),
            ("UNet L1 conv2 TP=4 shard", 3, 64, 64, 80, 320, False,
             False)]:
        x = rnd(b, h, w, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                           device=dev)
        a = torch.rand((b, cin), generator=g, device=dev) + 0.5
        sh = torch.randn((b, cin), generator=g, device=dev)
        r = rnd(b, h, w, cout) if res else None
        with torch.no_grad():
            act = conv.silu_affine(x, a, sh).to(x.dtype)
        pix = b * h * w
        cases.append(Case(
            "gnconv3x3", f"{label} B{b} {h}x{w} {cin}->{cout}",
            lambda x=x, w9=w9, bias=bias, a=a, sh=sh, r=r: conv.gnconv3x3(
                x, w9, bias, a, sh, r),
            lambda x=x, w9=w9, bias=bias, a=a, sh=sh, r=r:
                conv.gnconv3x3_plain(x, w9, bias, a, sh, r),
            lambda x=x, w9=w9, bias=bias, a=a, sh=sh, r=r:
                conv.gnconv3x3_plain(x.float(), w9.float(), bias, a, sh,
                                     None if r is None else r.float()),
            None, 2.0 * pix * 9 * cin * cout,
            2.0 * (pix * cin + 9 * cin * cout + pix * cout * (2 if res
                                                               else 1))
            + 4.0 * (bias.numel() + 2 * b * cin),
            twin=lambda act=act, w9=w9, bias=bias, r=r: conv.conv3x3(
                act, w9, bias, r), alone=conv_alone(x, w9, bias, r, a, sh)))
    for label, b, h, w, cin, cout, pad in [
            ("UNet L1", 3, 64, 64, 320, 320, (1, 1, 1, 1)),
            ("VAE enc 512px", 3, 512, 512, 128, 128, (0, 1, 0, 1)),
            ("VAE enc 128px", 3, 128, 128, 512, 512, (0, 1, 0, 1)),
            # the tiles for 16- and 8-column outputs
            ("UNet L2", 3, 32, 32, 640, 640, (1, 1, 1, 1)),
            ("UNet L3", 3, 16, 16, 1280, 1280, (1, 1, 1, 1)),
            ("ragged", 2, 45, 37, 96, 160, (0, 1, 0, 1)),
            # one input column and a Cout that 8 does not divide: the
            # wrapper pads both with zeros
            ("one column, Cout 20", 2, 9, 1, 16, 20, (1, 1, 1, 1))]:
        x = rnd(b, h, w, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((cout,), generator=g, device=dev)
        ho, wo = downconv.out_size(h, w, pad)
        # the yardstick: cuDNN's channels_last bf16 stride-2 convolution;
        # an asymmetric pad is applied to its input beforehand
        t, bo, le, ri = pad
        x_cl = F.pad(x.permute(0, 3, 1, 2), (le, ri, t, bo)).contiguous(
            memory_format=torch.channels_last)
        w_cl = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pix = b * ho * wo
        cases.append(Case(
            "downconv3x3",
            f"{label} B{b} {h}x{w}->{ho}x{wo} {cin}->{cout} pad {pad}",
            lambda x=x, w9=w9, bias=bias, pad=pad: downconv.downconv3x3(
                x, w9, bias, pad),
            lambda x=x, w9=w9, bias=bias, pad=pad:
                downconv.downconv3x3_plain(x, w9, bias, pad),
            lambda x=x, w9=w9, bias=bias, pad=pad:
                downconv.downconv3x3_plain(x.float(), w9.float(), bias, pad),
            lambda x=x_cl, w=w_cl, bb=bias.to(torch.bfloat16): F.conv2d(
                x, w, bb, stride=2),
            2.0 * pix * 9 * cin * cout,
            2.0 * (b * h * w * cin + 9 * cin * cout + pix * cout)
            + 4.0 * cout,
            alone=(down_alone(x, w9, bias, pad) if cout % 8 == 0 and w > 1
                   else None)))
    return cases


# (label, B, source H, W, channels) of kernel U: the UNet's three 2x
# upsamples (serving B3, its reference pass B6), the VAE decoder's three
# (B1) and a ragged source
UP_SITES = [("UNet up block 0", 3, 8, 8, 1280),
            ("UNet up block 1", 3, 16, 16, 1280),
            ("UNet up block 2", 3, 32, 32, 640),
            ("VAE dec 64->128px", 1, 64, 64, 512),
            ("VAE dec 128->256px", 1, 128, 128, 512),
            ("VAE dec 256->512px", 1, 256, 256, 256),
            ("UNet up block 0 ref pass", 6, 8, 8, 1280),
            ("UNet up block 1 ref pass", 6, 16, 16, 1280),
            ("UNet up block 2 ref pass", 6, 32, 32, 640),
            ("ragged", 2, 5, 6, 96)]


def _up_cases(dev, g, rnd):
    """U at UP_SITES, with the parent's path and F.interpolate + cuDNN's
    conv2d as yardsticks and cuDNN's transposed conv, one call of the same
    function, as library."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import conv, upconv
    cases = []
    for label, b, h, w, c in UP_SITES:
        x = rnd(b, h, w, c)
        weight = torch.randn((c, c, 3, 3), generator=g, device=dev) * (
            9 * c) ** -0.5
        w9 = conv.pack_weight(weight, torch.bfloat16)
        w16 = upconv.phase_weight(weight, torch.bfloat16)
        bias = torch.randn((c,), generator=g, device=dev)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = weight.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        k4 = transposed_weight(w16).contiguous(
            memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)
        pix = b * h * w
        cases.append(Case(
            "upconv3x3", f"{label} B{b} {h}x{w}->{2 * h}x{2 * w} {c}",
            lambda x=x, w16=w16, bias=bias: upconv.upconv3x3(x, w16, bias),
            lambda x=x, w16=w16, bias=bias: upconv.upconv3x3_plain(
                x, w16, bias),
            lambda x=x, w16=w16, bias=bias: upconv.upconv3x3_plain(
                x.float(), w16.float(), bias),
            lambda x=x_cl, k=k4, bb=b16: F.conv_transpose2d(
                x, k, bb, stride=2, padding=1),
            2.0 * pix * 16 * c * c,
            2.0 * (pix * c + 16 * c * c + 4 * pix * c) + 4.0 * c,
            alone=up_alone(x, w16, bias),
            yardsticks={
                "parent's path": lambda x=x, w9=w9, bias=bias: conv.conv3x3(
                    upconv.upsample_nearest(x), w9, bias),
                "interpolate + cuDNN": lambda x=x_cl, w=w_cl, bb=b16:
                    F.conv2d(F.interpolate(x, scale_factor=2,
                                           mode="nearest"), w, bb,
                             padding=1)}))
    return cases


# (label, B, source H, W, channels) of kernel UB, U's input gradient: the
# training path's three up blocks (batch 4), a ragged source and a
# one-column one
UB_SITES = [("UNet up block 0", 4, 8, 8, 1280),
            ("UNet up block 1", 4, 16, 16, 1280),
            ("UNet up block 2", 4, 32, 32, 640),
            ("ragged", 2, 5, 6, 96),
            ("one column", 2, 7, 1, 64)]


def _ub_cases(dev, g, rnd):
    """UB at UB_SITES: the gradient of U's source from the (B, 2H, 2W, C)
    cotangent, with the parent's path (kernel C on the 2x grid and the fp32
    2x2 sum) as yardstick and cuDNN's 4x4 stride-2 conv2d of the cotangent
    with the transposed phase weights, one call of UB's function, as
    library. The mean holds the wrapper's packing of the weights; "alone"
    is UB's kernels."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import conv, upconv
    cases = []
    for label, b, h, w, c in UB_SITES:
        gy = rnd(b, 2 * h, 2 * w, c)
        weight = torch.randn((c, c, 3, 3), generator=g, device=dev) * (
            9 * c) ** -0.5
        w9 = conv.pack_weight(weight, torch.bfloat16)
        w16 = upconv.phase_weight(weight, torch.bfloat16)
        g_cl = gy.permute(0, 3, 1, 2)
        k4 = transposed_weight(w16).contiguous(
            memory_format=torch.channels_last)
        pix = b * h * w
        cases.append(Case(
            "upconv3x3_dx", f"{label} B{b} {2 * h}x{2 * w}->{h}x{w} {c}",
            lambda gy=gy, w16=w16: upconv.upconv3x3_dx(gy, w16),
            lambda gy=gy, w16=w16: upconv.upconv3x3_dx_plain(gy, w16),
            lambda gy=gy, w16=w16: upconv.upconv3x3_dx_plain(
                gy.float(), w16.float()),
            lambda x=g_cl, k=k4: F.conv2d(x, k, stride=2, padding=1),
            2.0 * pix * 16 * c * c,
            2.0 * (4 * pix * c + 16 * c * c + pix * c),
            alone=ub_alone(gy, upconv.dx_weight(w16)),
            yardsticks={"parent's path": lambda gy=gy, w9=w9: parent_dx(
                gy, w9)}))
    return cases


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def phase_kernels(dev, card: str, results: dict) -> bool:
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    library_ms = {}  # the backward's three kernels share one yardstick
    backward_ms = {}  # SDPA's backward alone, per backward case
    dq_ms = {}  # DQ's time per backward case, for DQ+DKV's factor
    for c in kernel_cases(dev):
        with torch.no_grad():
            first = _as_tuple(c.kern())
            again = _as_tuple(c.kern()) if c.repeat else None
            outs = [o.float() for o in first]
            refs = [o.float() for o in _as_tuple(c.oracle())]
            twin = None if c.twin is None else c.twin().float()
        torch.cuda.synchronize()
        repeat_line = ""
        if again is not None:
            # DQ and DKV own their output tiles: a second run equals the
            # first bit for bit
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            ok &= same
            repeat_line = f" repeat {'equal' if same else 'DIFFERS'};"
        del first, again
        twin_line, twin_err = "", None
        if twin is not None:
            twin_err = (outs[0] - twin).abs().max().item()
            twin_bd = P_VS_C_RTOL * twin.abs().max().item()
            twin_ok = twin_err <= twin_bd
            ok &= twin_ok
            twin_line = (f" vs C on the applied prologue {twin_err:.3e} "
                         f"(bound {twin_bd:.3e}) "
                         f"{'ok' if twin_ok else 'FAIL'};")
        checks = []  # (error, bound, passed) of each output
        for o, r in zip(outs, refs):
            if o.shape != r.shape:
                checks.append((float("inf"), 0.0, False))
                continue
            # equal entries agree, infinite ones too (the -inf lse of a row
            # that keeps no ref); every other entry must be finite and near
            same = o == r
            e = torch.where(same, 0.0, (o - r).abs()).max().item()
            bd = KERNEL_RTOL * r[torch.isfinite(r)].abs().max().item()
            fin = bool((torch.isfinite(o) | same).all().item())
            checks.append((e, bd, fin and e <= bd))
        del outs, refs, twin
        good = all(x[2] for x in checks)
        # report the output that is furthest from its bound
        err, bound, _ = max(checks, key=lambda x: (not x[2],
                                                   x[0] / max(x[1], 1e-30)))
        with torch.no_grad():
            ms = cuda_ms(c.kern, 10)
            plain_ms = cuda_ms(c.plain, 3)
        lib_ms = None
        if c.library is not None:
            if c.library not in library_ms:
                library_ms[c.library] = cuda_ms(c.library, 5)
            lib_ms = library_ms[c.library]
        bwd_ms = None
        if c.backward is not None:
            if c.label not in backward_ms:
                call = c.backward()
                backward_ms[c.label] = cuda_ms(call, 5)
                del call
            bwd_ms = backward_ms[c.label]
        b_ms, b_term = bound_ms(c.flops, c.nbytes, c.exps)
        b_by = "bytes" if b_term == "bytes" else "operations"
        ok &= good
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
        if c.name == "flash_lse" and lib_ms is not None:
            lib += " (computes O too)"
        # the rate of F, M, L, DQ, DKV, C, P and D, and the factor of F, M,
        # L, C and D over SDPA or cuDNN on the same inputs; DQ+DKV's factor
        # over SDPA's backward alone on the DKV line
        rate = vs_lib = vs_bwd = None
        fwd_line = ""
        if c.name in RATED:
            rate = c.flops / ms / 1e9
            fwd_line = f"  {rate:.1f} TFLOP/s"
            if lib_ms is not None and RATED[c.name] is not None:
                vs_lib = ms / lib_ms
                fwd_line = f"  {vs_lib:.2f}x {RATED[c.name]}" + fwd_line
        if c.name == "flash_dq":
            dq_ms[c.label] = ms
        unfused_ms = None
        if c.unfused is not None:
            # G: its HBM rate and the unfused chain (its share of its
            # bound below)
            with torch.no_grad():
                unfused_ms = cuda_ms(c.unfused, 10)
            fwd_line += (f"  {c.nbytes / ms / 1e6:.0f} GB/s  "
                         f"unfused {unfused_ms:.4f} ms "
                         f"({ms / unfused_ms:.2f}x)")
        yard = {}  # U's yardsticks: (mean ms, device ms alone)
        for name, fn in c.yardsticks.items():
            with torch.no_grad():
                yard[name] = (cuda_ms(fn, 10), kernels_ms(fn))
            y_ms, y_dev = yard[name]
            y_txt = "-" if y_dev is None else f"{y_dev:.4f} ms"
            fwd_line += (f"  {name} {y_ms:.4f} ms (alone {y_txt}; kernel "
                         f"{ms / y_ms:.2f}x it)")
        wrapper_us = alone_us = dev_ms = None
        if c.alone is not None:
            # C, P, D, F, M, L, DQ, DKV and G: share of bound, the device time
            # of the call's kernels alone (C's split reduction included),
            # and the host's cost of a call, through the wrapper and of the
            # C launcher
            with torch.no_grad():
                dev_ms = device_ms(c.kern, c.device)
                wrapper_us, alone_us = host_us(c.kern), host_us(c.alone)
            alone_txt = "-" if dev_ms is None else f"{dev_ms:.4f} ms"
            fwd_line += (f"  {b_ms / ms:.1%} of bound  device time alone "
                         f"{alone_txt}  host {wrapper_us:.1f} us (launcher alone "
                         f"{alone_us:.1f} us)")
        if bwd_ms is not None:
            fwd_line += f"  SDPA backward {bwd_ms:.4f} ms"
            if c.name == "flash_dkv" and c.label in dq_ms:
                vs_bwd = (dq_ms[c.label] + ms) / bwd_ms
                fwd_line += f", DQ+DKV {vs_bwd:.2f}x it"
        print(f"kernel {c.name:16s} {c.label:38s} max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'};{twin_line}"
              f"{repeat_line}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib}  "
              f"bound {b_ms:.4f} ms ({b_term}){fwd_line}  [{card}]", flush=True)
        r = results.setdefault(c.name, {
            "name": c.name, **KERNEL_META[c.name], "launches": 0,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": b_by, "library_ms": None, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if twin_err is not None:
            r["max_abs_err_vs_c"] = max(r.get("max_abs_err_vs_c", 0.0),
                                        twin_err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["cases"].append({"case": c.label, "max_abs_err": err,
                           "bound": bound, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "bound_term": b_term, "library_ms": lib_ms,
                           "max_abs_err_vs_c": twin_err, "tflops": rate,
                           "vs_library": vs_lib,
                           "sdpa_backward_ms": bwd_ms,
                           "dq_dkv_vs_sdpa_backward": vs_bwd,
                           "unfused_ms": unfused_ms,
                           "yardsticks_ms": yard or None,
                           "host_us": wrapper_us,
                           "host_alone_us": alone_us,
                           "device_alone_ms": dev_ms})
    for r in results.values():  # the bound of the kernel's summed cases
        r["bound_by"] = max(r["cases"], key=lambda x: x["bound_ms"])[
            "bound_by"]
    ok &= conv_split_checks(dev, card)
    ok &= down_lse_batch_checks(dev, card)
    ok &= upconv_split_checks(dev, card)
    ok &= ub_split_checks(dev, card)
    ok &= geglu_split_checks(dev, card)
    ok &= conv_ptxas()
    ok &= flash_ptxas()
    ok &= geglu_ptxas()
    torch.cuda.empty_cache()
    return ok


# (label, B, side, Cin, Cout, per-batch bias, residual) of kernel C at the
# sites whose wgmma line splits the 9 Cin reduction
SPLIT_SITES = [("UNet L3", 3, 16, 1280, 1280, False, False),
               ("UNet mid (B,C) bias + residual", 3, 8, 1280, 1280, True,
                True),
               ("UNet up block 1", 3, 8, 2560, 1280, False, False)]


def conv_split_checks(dev, card: str) -> bool:
    """At the split sites: kernel C run twice is equal bit for bit, C at B3
    equals its three B1 calls bit for bit (the split plan and each output's
    order of summation ignore the batch), and the B3 result stays within
    KERNEL_RTOL of the fp32 plain version."""
    import torch
    from storygen_tpu_torch.ops import conv
    g = torch.Generator(device=dev).manual_seed(1)
    ok = True
    for label, b, hw, cin, cout, bias_b, res in SPLIT_SITES:
        x = (torch.randn((b, hw, hw, cin), generator=g, device=dev)
             .to(torch.bfloat16))
        w9 = (torch.randn((9, cin, cout), generator=g, device=dev)
              * (9 * cin) ** -0.5).to(torch.bfloat16)
        bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                           device=dev)
        r = (torch.randn((b, hw, hw, cout), generator=g, device=dev)
             .to(torch.bfloat16) if res else None)
        with torch.no_grad():
            one = conv.conv3x3(x, w9, bias, r)
            two = conv.conv3x3(x, w9, bias, r)
            rows = torch.cat([conv.conv3x3(
                x[i:i + 1].contiguous(), w9,
                bias[i:i + 1].contiguous() if bias_b else bias,
                None if r is None else r[i:i + 1].contiguous())
                for i in range(b)])
            ref = conv.conv3x3_plain(x.float(), w9.float(), bias,
                                     None if r is None else r.float())
        torch.cuda.synchronize()
        repeat, sliced = torch.equal(one, two), torch.equal(one, rows)
        err = (one.float() - ref).abs().max().item()
        bound = KERNEL_RTOL * ref.abs().max().item()
        good = (repeat and sliced and err <= bound
                and bool(torch.isfinite(one.float()).all()))
        ok &= good
        print(f"conv split {label} B{b} {hw}x{hw} {cin}->{cout}: splits "
              f"{conv.conv_splits(False, cin, cout, hw, hw)}, repeat "
              f"{'equal' if repeat else 'DIFFERS'}, B{b} vs {b} x B1 "
              f"{'equal' if sliced else 'DIFFERS'}, max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'} [{card}]",
              flush=True)
    return ok


# (label, B, H, W, Cin, Cout, pad) of kernel D, and (label, B, Sq, Skv,
# head dim, keep table) of kernel L, whose results must not depend on the
# batch
DOWN_BATCH_SITES = [("UNet L3", 3, 16, 16, 1280, 1280, (1, 1, 1, 1)),
                    ("UNet L3", 4, 16, 16, 1280, 1280, (1, 1, 1, 1)),
                    ("VAE enc 128px", 3, 128, 128, 512, 512, (0, 1, 0, 1)),
                    ("VAE enc 128px", 4, 128, 128, 512, 512, (0, 1, 0, 1))]
LSE_BATCH_SITES = [("attn1 L1", 4, 4096, 4096, 40, None),
                   ("masked attn3 L1", 4, 4096, 12288, 40, KEEP)]


def down_lse_batch_checks(dev, card: str) -> bool:
    """Kernels D and L hold their result whatever the batch: each run twice
    is equal bit for bit, each equals its per-image calls bit for bit (D's
    split plan and every output's order of summation ignore the batch; L's
    blocks each own one image's rows), and each stays within KERNEL_RTOL
    of its fp32 plain version."""
    import torch
    from storygen_tpu_torch.ops import downconv, flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    def report(name, label, one, two, rows, ref, extra):
        repeat, sliced = torch.equal(one, two), torch.equal(one, rows)
        same = one.float() == ref
        err = torch.where(same, 0.0, (one.float() - ref).abs()).max().item()
        bound = KERNEL_RTOL * ref[torch.isfinite(ref)].abs().max().item()
        good = (repeat and sliced and err <= bound and bool(
            (torch.isfinite(one.float()) | same).all()))
        print(f"{name} batch {label}: {extra}repeat "
              f"{'equal' if repeat else 'DIFFERS'}, B vs per-image calls "
              f"{'equal' if sliced else 'DIFFERS'}, max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'} [{card}]",
              flush=True)
        return good

    ok = True
    for label, b, h, w, cin, cout, pad in DOWN_BATCH_SITES:
        x = randn(b, h, w, cin)
        w9 = randn(9, cin, cout, scale=(9 * cin) ** -0.5)
        bias = torch.randn((cout,), generator=g, device=dev)
        ho, wo = downconv.out_size(h, w, pad)
        with torch.no_grad():
            one = downconv.downconv3x3(x, w9, bias, pad)
            two = downconv.downconv3x3(x, w9, bias, pad)
            rows = torch.cat([downconv.downconv3x3(x[i:i + 1].contiguous(),
                                                   w9, bias, pad)
                              for i in range(b)])
            ref = downconv.downconv3x3_plain(x.float(), w9.float(), bias,
                                             pad)
        torch.cuda.synchronize()
        ok &= report("downconv3x3", f"{label} B{b} {h}x{w}->{ho}x{wo} "
                     f"{cin}->{cout}", one, two, rows, ref,
                     f"splits {downconv.down_splits(cin, cout, ho, wo)}, ")
        del x, w9, one, two, rows, ref
    for label, b, sq, skv, d, table in LSE_BATCH_SITES:
        heads = 8
        q, k = randn(b, sq, heads * d), randn(b, skv, heads * d)
        keep = (None if table is None else
                torch.tensor(table, dtype=torch.bool, device=dev))
        sc = d ** -0.5

        def lse(i=None):
            if i is None:
                return fa.flash_lse(q, k, heads, sc, keep)
            return fa.flash_lse(q[i:i + 1], k[i:i + 1], heads, sc,
                                None if keep is None else keep[i:i + 1])

        with torch.no_grad():
            one, two = lse(), lse()
            rows = torch.cat([lse(i) for i in range(b)])
            ref = fa.flash_lse_plain(q.float(), k.float(), heads, sc, keep)
        torch.cuda.synchronize()
        ok &= report("flash_lse", f"{label} B{b} {sq}x{skv} d{d}", one, two,
                     rows, ref, "")
        del q, k, one, two, rows, ref
    return ok


# (label, batches, source side, channels) of kernel U at the UNet's 2x
# upsamples: serving's CFG batch and its reference pass's
UP_BATCH_SITES = [("UNet up block 0", (3, 6), 8, 1280),
                  ("UNet up block 1", (3, 6), 16, 1280),
                  ("UNet up block 2", (3, 6), 32, 640)]


def upconv_split_checks(dev, card: str) -> bool:
    """Kernel U holds its result whatever the batch: run twice it is equal
    bit for bit, at B3 and B6 it equals its per-image calls bit for bit
    (the line, the split plan and each output's order of summation ignore
    the batch), and it stays within KERNEL_RTOL of its fp32 plain
    version."""
    import torch
    from storygen_tpu_torch.ops import upconv
    g = torch.Generator(device=dev).manual_seed(4)
    ok = True
    for label, batches, side, c in UP_BATCH_SITES:
        weight = torch.randn((c, c, 3, 3), generator=g, device=dev) * (
            9 * c) ** -0.5
        w16 = upconv.phase_weight(weight, torch.bfloat16)
        bias = torch.randn((c,), generator=g, device=dev)
        for b in batches:
            x = torch.randn((b, side, side, c), generator=g,
                            device=dev).to(torch.bfloat16)
            with torch.no_grad():
                one = upconv.upconv3x3(x, w16, bias)
                two = upconv.upconv3x3(x, w16, bias)
                rows = torch.cat([upconv.upconv3x3(x[i:i + 1].contiguous(),
                                                   w16, bias)
                                  for i in range(b)])
                ref = upconv.upconv3x3_plain(x.float(), w16.float(), bias)
            torch.cuda.synchronize()
            repeat, sliced = torch.equal(one, two), torch.equal(one, rows)
            err = (one.float() - ref).abs().max().item()
            bound = KERNEL_RTOL * ref.abs().max().item()
            good = (repeat and sliced and err <= bound
                    and bool(torch.isfinite(one.float()).all()))
            ok &= good
            print(f"upconv3x3 batch {label} B{b} {side}x{side}->"
                  f"{2 * side}x{2 * side} {c}: splits "
                  f"{upconv.up_splits(c, c, side, side)}, repeat "
                  f"{'equal' if repeat else 'DIFFERS'}, B{b} vs {b} x B1 "
                  f"{'equal' if sliced else 'DIFFERS'}, max_abs_err "
                  f"{err:.3e} (bound {bound:.3e}) "
                  f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
            del x, one, two, rows, ref
    return ok


# (label, batches, source side, channels) of kernel UB at the training
# path's three up blocks
UB_BATCH_SITES = [("UNet up block 0", (1, 2, 4), 8, 1280),
                  ("UNet up block 1", (1, 2, 4), 16, 1280),
                  ("UNet up block 2", (1, 2, 4), 32, 640)]


def ub_split_checks(dev, card: str) -> bool:
    """Kernel UB holds its result whatever the batch: run twice it is
    equal bit for bit, at B1, B2 and B4 it equals its per-image calls bit
    for bit (the line, the split plan and each output's order of
    summation ignore the batch), and it stays within KERNEL_RTOL of its
    fp32 plain version."""
    import torch
    from storygen_tpu_torch.ops import upconv
    g = torch.Generator(device=dev).manual_seed(5)
    ok = True
    for label, batches, side, c in UB_BATCH_SITES:
        weight = torch.randn((c, c, 3, 3), generator=g, device=dev) * (
            9 * c) ** -0.5
        w16 = upconv.phase_weight(weight, torch.bfloat16)
        for b in batches:
            gy = torch.randn((b, 2 * side, 2 * side, c), generator=g,
                             device=dev).to(torch.bfloat16)
            with torch.no_grad():
                one = upconv.upconv3x3_dx(gy, w16)
                two = upconv.upconv3x3_dx(gy, w16)
                rows = torch.cat([upconv.upconv3x3_dx(
                    gy[i:i + 1].contiguous(), w16) for i in range(b)])
                ref = upconv.upconv3x3_dx_plain(gy.float(), w16.float())
            torch.cuda.synchronize()
            repeat, sliced = torch.equal(one, two), torch.equal(one, rows)
            err = (one.float() - ref).abs().max().item()
            bound = KERNEL_RTOL * ref.abs().max().item()
            good = (repeat and sliced and err <= bound
                    and bool(torch.isfinite(one.float()).all()))
            ok &= good
            print(f"upconv3x3_dx batch {label} B{b} {2 * side}x{2 * side}->"
                  f"{side}x{side} {c}: splits "
                  f"{upconv.dx_splits(c, c, side, side)}, repeat "
                  f"{'equal' if repeat else 'DIFFERS'}, B{b} vs {b} x B1 "
                  f"{'equal' if sliced else 'DIFFERS'}, max_abs_err "
                  f"{err:.3e} (bound {bound:.3e}) "
                  f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
            del gy, one, two, rows, ref
    return ok


# (label, rows per image, N, E, batches) of kernel G at the sites whose
# line splits the N reduction, and a ragged M (250 rows an image)
GEGLU_SPLIT_SITES = [("L3 ff", 256, 5120, 1280, (3, 4)),
                     ("mid ff", 64, 5120, 1280, (3, 6)),
                     ("mid train ff", 64, 5120, 1280, (4, 12)),
                     ("ragged", 250, 5120, 1280, (4, 3))]


def geglu_split_checks(dev, card: str) -> bool:
    """At the split sites: kernel G run twice is equal bit for bit, G at
    each batch equals its per-image calls bit for bit (the tile, the split
    and each row's order of summation ignore the batch), and the batched
    result stays within KERNEL_RTOL of the fp32 plain version."""
    import torch
    from storygen_tpu_torch.ops import geglu
    g = torch.Generator(device=dev).manual_seed(2)
    ok = True
    for label, tokens, n, e, batches in GEGLU_SPLIT_SITES:
        w = (torch.randn((e, n), generator=g, device=dev) * n ** -0.5).to(
            torch.bfloat16)
        bias = torch.randn((e,), generator=g, device=dev).to(torch.bfloat16)
        tile = geglu.geglu_tile(tokens, n, e)
        for b in batches:
            m = b * tokens
            p = torch.randn((m, 2 * n), generator=g, device=dev).to(
                torch.bfloat16)
            with torch.no_grad():
                one = geglu.geglu_matmul(p, w, bias, tokens)
                two = geglu.geglu_matmul(p, w, bias, tokens)
                rows = torch.cat([geglu.geglu_matmul(
                    p[i * tokens:(i + 1) * tokens].contiguous(), w, bias,
                    tokens) for i in range(b)])
                ref = geglu.geglu_matmul_plain(p.float(), w.float(),
                                               bias.float())
            torch.cuda.synchronize()
            repeat, sliced = torch.equal(one, two), torch.equal(one, rows)
            err = (one.float() - ref).abs().max().item()
            bound = KERNEL_RTOL * ref.abs().max().item()
            good = (repeat and sliced and err <= bound
                    and bool(torch.isfinite(one.float()).all()))
            ok &= good
            print(f"geglu split {label} B{b} ({m}, 2x{n})->{e}: tile "
                  f"{tile}, split {geglu.split_count(tile, n)}, repeat "
                  f"{'equal' if repeat else 'DIFFERS'}, B{b} vs {b} x B1 "
                  f"{'equal' if sliced else 'DIFFERS'}, max_abs_err "
                  f"{err:.3e} (bound {bound:.3e}) "
                  f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
            del p, one, two, rows, ref
    return ok


def wg_ptxas(stem: str, entry: str, built: set) -> bool:
    """Registers and spill bytes of every instantiation of the wgmma
    kernel `entry` in this run's build of csrc/<stem>.cu
    (`<hash>/<stem>.ptxas.txt`), and any wgmma serialisation ptxas
    reports; False if one spills, ptxas serialises a wgmma, or a line of
    `built` (template argument tuples) has no report."""
    import re
    from storygen_tpu_torch.ops import _build
    from storygen_tpu_torch.studies.common import ptxas_summary
    text = _build.ptxas_report(stem)
    ok, seen = True, set()
    for name, regs, stack, stores, loads in ptxas_summary(text):
        # template arguments: Lb<0|1>E (bool), Li<n>E (int)
        m = re.search(rf"{entry}[^I]*I((?:L[ib]-?\d+E)+)E", name)
        if m is None:
            continue
        args = tuple(int(v) for v in re.findall(r"L[ib](-?\d+)E",
                                                m.group(1)))
        seen.add(args)
        good = stores == 0 and loads == 0
        ok &= good
        print(f"ptxas {entry}<{', '.join(map(str, args))}>: {regs} "
              f"registers, {stack} bytes stack, {stores} bytes spill "
              f"stores, {loads} bytes spill loads {'ok' if good else 'FAIL'}",
              flush=True)
    for line in text.splitlines():
        if "serializ" in line:
            ok = False
            print(f"ptxas: {line.strip()} FAIL", flush=True)
    missing = built - seen
    ok &= not missing
    print(f"ptxas {stem}: {len(seen)} wgmma instantiations reported, "
          f"{len(built)} built, missing {sorted(missing)} "
          f"{'ok' if not missing else 'FAIL'}", flush=True)
    return ok


def conv_ptxas() -> bool:
    """wg_ptxas of every wgmma conv instantiation in this run's build:
    C's and P's (`<hash>/conv3x3.ptxas.txt`, each CONV_BUILT line of
    family WGMMA), D's (`downconv3x3.ptxas.txt`, each DOWN_BUILT line),
    U's (`upconv3x3.ptxas.txt`, each UP_BUILT line) and UB's
    (`upconv_dx3x3.ptxas.txt`, each UB_BUILT line)."""
    from storygen_tpu_torch.ops import conv, downconv, upconv
    # (stride, mode: 0 plain, 1 P's prologue, 2 U's phases, 3 UB's 4x4
    # window, TH, TW, IB, WGM, MT, BN, CK, stages)
    built = {(1, k[1]) + v[1:] for k, v in conv.CONV_BUILT.items()
             if v[0] == conv.WGMMA}
    down = {(2, 0) + v[1:] for v in downconv.DOWN_BUILT.values()}
    up = {(1, 2) + v[1:] for v in upconv.UP_BUILT.values()}
    ub = {(2, 3) + v[1:] for v in upconv.UB_BUILT.values()}
    ok = wg_ptxas("conv3x3", "wg_conv_kernel", built)
    ok &= wg_ptxas("downconv3x3", "wg_conv_kernel", down)
    ok &= wg_ptxas("upconv_dx3x3", "wg_conv_kernel", ub)
    return wg_ptxas("upconv3x3", "wg_conv_kernel", up) and ok


def flash_ptxas() -> bool:
    """wg_ptxas of every instantiation of F / M and of L
    (`flash_fwd.ptxas.txt`: the unmasked, masked and straddling kernels of
    each FWD_BUILT and LSE_BUILT line) and of DQ / DKV
    (`flash_bwd.ptxas.txt`, each BWD_BUILT line)."""
    from storygen_tpu_torch.ops import flash_attention as fa
    # (DP, warpgroups, BK, stages, panel, ping-pong, masked, straddle)
    fwd = {(dp, bq // 64, bk, st, a, b, int(masked), straddle)
           for (dp, masked), (bq, bk, st, a, b) in fa.FWD_BUILT.items()
           for straddle in ((0, 1) if masked else (0,))}
    # (DP, warpgroups, BK, stages, panel, masked, straddle)
    lse = {(dp, bq // 64, bk, st, a, int(masked), straddle)
           for (dp, masked), (bq, bk, st, a) in fa.LSE_BUILT.items()
           for straddle in ((0, 1) if masked else (0,))}
    # (DKV, DP, warpgroups, BC, stages, panel, ping-pong, masked, straddle)
    bwd = {(int(kernel == "dkv"), dp, br // 64, bc, st, a, b, int(masked),
            straddle)
           for (kernel, dp, masked), (br, bc, st, a, b)
           in fa.BWD_BUILT.items()
           for straddle in ((0, 1) if masked else (0,))}
    ok = wg_ptxas("flash_fwd", "flash_wg_kernel", fwd)
    ok &= wg_ptxas("flash_fwd", "lse_wg_kernel", lse)
    return wg_ptxas("flash_bwd", "flash_bwd_wg_kernel", bwd) and ok


def geglu_ptxas() -> bool:
    """wg_ptxas of every instantiation of G (`geglu_matmul.ptxas.txt`:
    each GEGLU_BUILT line with a bf16 and an fp32 bias)."""
    from storygen_tpu_torch.ops import geglu
    built = {tile[:5] + (b32,) for tile in geglu.GEGLU_BUILT.values()
             for b32 in (0, 1)}
    return wg_ptxas("geglu_matmul", "geglu_wg_kernel", built)


def conv_kernels(config: str):
    """The conv configuration of a phase: "default" or "fused"."""
    from storygen_tpu_torch.configs import ConvKernels
    return {"default": ConvKernels(),
            "fused": ConvKernels(fused_prologue=True, strided=True)}[config]


def full_width_models(dev, conv=None):
    """SD-1.5 + VLCM UNet, VAE and CLIP ViT-L/14 text encoder at their
    published widths, bf16, seeded random weights; `conv`
    (configs.ConvKernels, the default one if None) picks the kernels of the
    UNet's and the VAE's convs. The weights do not depend on it."""
    import torch
    from storygen_tpu_torch.configs import (CLIPTextConfig, ConvKernels,
                                            UNetConfig, VAEConfig)
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    conv = conv or ConvKernels()

    def make(cls, seed, *args):
        with torch.device(dev):  # allocate on the card, skip CPU init
            module = cls(*args)
        return init_random_(module.to(torch.bfloat16), seed).eval()

    return (make(UNet2DConditionModel, 1, UNetConfig(), conv),
            make(AutoencoderKL, 2, VAEConfig(), conv),
            make(CLIPTextModel, 3, CLIPTextConfig()))


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


def write_bpe_files(path: str, corpus, num_merges: int) -> None:
    """vocab.json and merges.txt of a byte-level BPE learned from `corpus`
    (no vocab ships with the repository): the 256 byte characters at ids
    0-255 and with `</w>` at 256-511, the merges' tokens after them, and
    <|startoftext|> / <|endoftext|> at CLIP's ids 49406 / 49407."""
    import collections

    from storygen_tpu_torch.data import tokenizer as T
    chars = list(T.BYTE_CHARS.values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    words = collections.Counter()
    for text in corpus:
        for w in T.words(T.normalize(text)):
            b = "".join(T.BYTE_CHARS[x] for x in w.encode("utf-8"))
            words[tuple(b[:-1]) + (b[-1] + "</w>",)] += 1
    merges = []
    for _ in range(num_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        vocab.setdefault("".join(best), len(vocab))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "".join(f"{a} {b}\n" for a, b in merges))


def write_storysalon_tree(root: str, stories: int, frames: int, size: int,
                          test: int = 1) -> None:
    """A StorySalon video-source tree of seeded PNGs (8 x 8 colour cells
    over a smooth gradient, with grain), masks and captions; the last
    `test` stories are held out in video_test_set.txt. PIL writes the
    files, choosing each row's filter as encoders of real files do."""
    import numpy as np
    from PIL import Image

    def write(path, a):
        Image.fromarray(a).save(path)
    yy, xx = np.mgrid[0:size, 0:size] * (96.0 / size)
    ramp = np.stack([yy, xx, (yy + xx) / 2], -1)
    for s in range(stories):
        sid = f"story{s:03d}"
        dirs = [os.path.join(root, sub, sid) for sub in (
            "image_inpainted_finally_checked", "mask",
            os.path.join("Text", "Caption", "Video"))]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for i in range(frames):
            rs = np.random.RandomState([s, i])
            block = size // 8
            cells = rs.randint(0, 160, (8, 8, 3)).repeat(block, 0).repeat(
                block, 1)
            grain = rs.normal(0, 4, (size, size, 3))
            write(os.path.join(dirs[0], f"{i}.png"),
                  np.clip(cells + ramp + grain, 0, 255).astype(np.uint8))
            mask = np.full((size, size, 3), 255, np.uint8)
            mask[:size // 10] = 0  # a text band, as inpainted pages have
            write(os.path.join(dirs[1], f"{i}.png"), mask)
            with open(os.path.join(dirs[2], f"{i}.txt"), "w") as f:
                f.write(PROMPTS[(s + i) % len(PROMPTS)])
    with open(os.path.join(root, "video_test_set.txt"), "w") as f:
        f.write("".join(f"story{s:03d}\n"
                        for s in range(stories - test, stories)))


def png_filters(path: str) -> list:
    """How many rows of an 8-bit RGB PNG use each of the five filters."""
    import struct
    import zlib

    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, width = 8, b"", 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            width = struct.unpack(">I", data[pos + 8:pos + 12])[0]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return np.bincount(raw[::1 + 3 * width], minlength=5).tolist()


def loader_times(tree: str, card: str) -> None:
    """Host seconds to decode the tree's 512 px frames with PIL and with
    utils/image.py's reader (the decoder of a host without PIL), and to
    make a StorySalon training sample (5 decodes: 4 frames and a mask);
    prints them with the rows' filters."""
    import glob

    import numpy as np
    from PIL import Image
    from storygen_tpu_torch.data.datasets import StorySalonDataset
    from storygen_tpu_torch.utils.image import read_png
    frames = sorted(glob.glob(os.path.join(
        tree, "image_inpainted_finally_checked", "*", "*.png")))[:8]
    filters = np.sum([png_filters(p) for p in frames], 0).tolist()
    times = {}
    for name, decode in (
            ("pil_decode", lambda p: np.asarray(
                Image.open(p).convert("RGB"))),
            ("read_png", read_png)):
        t0 = time.perf_counter()
        for p in frames:
            decode(p)
        times[name] = (time.perf_counter() - t0) / len(frames)
    ds = StorySalonDataset(tree, "train")
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    times["sample"] = (time.perf_counter() - t0) / len(ds)
    print(f"cli loader: {len(frames)} frames, rows by filter 0-4 "
          f"{filters}; per frame PIL {times['pil_decode'] * 1e3:.2f} ms, "
          f"read_png {times['read_png'] * 1e3:.2f} ms; per StorySalon "
          f"sample ({len(ds)}, PIL) {times['sample'] * 1e3:.2f} ms [{card}]",
          flush=True)


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


def stage2_grads_vs_plain(unet, dev, card: str, config: str) -> bool:
    """One stage-2 main pass at B2, 512 px, 3 refs under KEEP's first two
    rows, masked MSE: loss and every attn3 gradient, kernel path against
    plain path (gradient checkpointing on, as in training)."""
    import torch
    from storygen_tpu_torch import ops
    from storygen_tpu_torch.training import optim
    from storygen_tpu_torch.training.losses import downsample_mask, masked_mse
    unet.gradient_checkpointing = True
    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES["stage2"])
    for p in trainable.values():
        p.data = p.data.float()
    g = torch.Generator(device=dev).manual_seed(12)
    n, b = 3, 2
    with torch.no_grad():
        refs = torch.randn((n * b, 64, 64, 4), generator=g, device=dev)
        rtext = torch.randn((n * b, 77, 768), generator=g, device=dev)
        t_ref = torch.tensor([150, 20] * n, device=dev) * torch.arange(
            n, 0, -1, device=dev).repeat_interleave(b)
        _, raw = unet(refs, t_ref, rtext)
        ctx = {k: v.reshape((n, b) + v.shape[1:]).transpose(0, 1)
               .reshape(b, n * v.shape[1], v.shape[2])
               for k, v in raw.items()}
    x = torch.randn((b, 64, 64, 4), generator=g, device=dev)
    noise = torch.randn((b, 64, 64, 4), generator=g, device=dev)
    text = torch.randn((b, 77, 768), generator=g, device=dev)
    t = torch.tensor([500, 80], device=dev)
    keep = torch.tensor(KEEP[:b], dtype=torch.bool, device=dev)
    lmask = downsample_mask((torch.rand((b, 512, 512, 1), generator=g,
                                        device=dev) > 0.8).float())
    names = list(trainable)

    def run():
        pred, _ = unet(x, t, text, ctx, keep)
        loss = masked_mse(pred, noise, lmask)
        grads = torch.autograd.grad(loss, [trainable[k] for k in names])
        return loss.detach().float(), [gr.float() for gr in grads]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, grads_k = run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with ops.plain_path():
        loss_p, grads_p = run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rel_loss = (abs(loss_k - loss_p) / abs(loss_p)).item()
    per = [((a - p).norm() / p.norm()).item()
           for a, p in zip(grads_k, grads_p)]
    flat_k, flat_p = (torch.cat([x.flatten() for x in gs])
                      for gs in (grads_k, grads_p))
    rel_all = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    worst = max(range(len(per)), key=per.__getitem__)
    finite = bool(torch.isfinite(flat_k).all().item()) and bool(
        torch.isfinite(loss_k).item())
    ok = (finite and rel_loss <= MODEL_REL_L2 and max(per) <= GRAD_REL_L2
          and len(names) == 16 * 5)
    print(f"[{config}] stage-2 main pass B2 512px 3 refs masked: loss kernel "
          f"{loss_k.item():.6f} plain {loss_p.item():.6f} rel "
          f"{rel_loss:.3e} (bound {MODEL_REL_L2:.0e}); {len(names)} attn3 "
          f"grads rel L2 all {rel_all:.3e}, worst {per[worst]:.3e} at "
          f"{names[worst]} (bound {GRAD_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'}; kernel path {1e3 * (t1 - t0):.1f} ms,"
          f" plain path {1e3 * (t2 - t1):.1f} ms (first calls) [{card}]",
          flush=True)
    return ok


def phase_models(dev, card: str) -> bool:
    """In each conv configuration: one image-cycle UNet pass (3-row CFG
    batch, 3 refs at 64x64 latents), one 512 px VAE encode and one decode,
    each on the kernel path against the plain path on the same inputs; then
    the stage-2 pass."""
    ok = True
    for config in ("default", "fused"):
        ok &= models_vs_plain(dev, card, config)
    return ok


def models_vs_plain(dev, card: str, config: str) -> bool:
    import torch
    from storygen_tpu_torch.pipeline import StoryGenSampler
    unet, vae, _ = full_width_models(dev, conv_kernels(config))
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
    ok = kernel_vs_plain(f"[{config}] unet image cycle B3 64x64 3 refs",
                         lambda: unet(x, 481, text, ctx)[0], (3, 64, 64, 4),
                         card)
    ok &= kernel_vs_plain(f"[{config}] vae encode B1 512x512 (posterior "
                          "mean)", lambda: vae.encode(image).mean,
                          (1, 64, 64, 4), card)
    ok &= kernel_vs_plain(f"[{config}] vae decode B1 64x64 latents (before "
                          "the clamp)", lambda: vae.decode(z),
                          (1, 512, 512, 3), card)
    del vae, raw, ctx
    ok &= stage2_grads_vs_plain(unet, dev, card, config)
    del unet
    torch.cuda.empty_cache()
    return ok


PROMPTS = ("A little fox finds a glowing lantern in the snowy forest.",
           "The fox carries the lantern along a frozen river at dusk.",
           "An owl watches the fox from a pine branch under the stars.",
           "The fox and the owl share the lantern light in a warm den.")


def record_launches(results: dict, launches: dict, path: str) -> bool:
    """Keep the launches of one path's run; True if every kernel the path
    must run launched and every other kernel did not. "launches" itself is
    the fused training path's count, the one path that runs all ten
    serving and training kernels, and the studies path's for the study
    kernels."""
    for k, n in launches.items():
        r = results.setdefault(k, {"name": k, **KERNEL_META[k]})
        r.setdefault("launches_by_path", {})[path] = n
        if path == ("studies" if k in STUDY_KERNELS else "train_fused"):
            r["launches"] = n
    good = launches_ok(launches, path)
    print(f"{path}-path launches: {json.dumps(launches)} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    if path in C_LAUNCHES_BEFORE_UB:
        c, ub = launches["conv3x3"], launches["upconv3x3_dx"]
        same = c + ub == C_LAUNCHES_BEFORE_UB[path]
        good &= same
        print(f"{path}-path: C {c} + UB {ub} = {c + ub}, C before UB "
              f"{C_LAUNCHES_BEFORE_UB[path]} {'ok' if same else 'FAIL'}",
              flush=True)
    return good


def phase_story(dev, card: str, results: dict,
                config: str = "default") -> bool:
    """The serving path: a generate_story at 512x512, DDIM, guidance 7.5 /
    image guidance 3.5, frames after the first conditioned on up to 3 refs:
    4 prompts in the default configuration, 2 in the fused one."""
    import numpy as np
    import torch
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    prompts = PROMPTS if config == "default" else PROMPTS[:2]
    path = "story" if config == "default" else "story_fused"
    unet, vae, clip = full_width_models(dev, conv_kernels(config))
    pipe = StoryGenPipeline(unet, vae, clip, token_ids, device=dev)
    marks = []
    decode = pipe.sampler.decode

    def timed_decode(latents):
        img = decode(latents)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return img

    pipe.sampler.decode = timed_decode
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.generate_story(list(prompts),
                                 num_inference_steps=STORY_STEPS,
                                 height=512, width=512, guidance_scale=7.5,
                                 image_guidance_scale=3.5, seed=0)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    per_frame = np.diff([t0] + marks)
    ok = len(frames) == len(prompts)
    for i, f in enumerate(frames):
        good = (f.shape == (512, 512, 3) and bool(np.isfinite(f).all())
                and f.min() >= 0.0 and f.max() <= 1.0)
        ok &= good
        print(f"frame {i + 1}: shape {f.shape} range [{f.min():.3f}, "
              f"{f.max():.3f}] mean {f.mean():.3f} "
              f"{'ok' if good else 'FAIL'}")
    print(f"{path}: {len(frames)} frames 512x512, DDIM-{STORY_STEPS}, "
          f"refs up to 3, "
          f"bf16: total {total:.2f} s, per frame "
          f"{', '.join(f'{s:.2f}' for s in per_frame)} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    ok &= record_launches(results, launches, path)
    del pipe, unet, vae, clip
    torch.cuda.empty_cache()
    return ok


# The serving-options phase: DDIM-style steps per sampler frame, and each
# sampler with the eta it runs at (eta > 0 only where the sampler takes it)
OPTION_STEPS = 4
SAMPLER_RUNS = (("ddim", 0.5), ("dpm++", 0.0), ("pndm", 0.0), ("lms", 0.0),
                ("euler", 0.0), ("euler_a", 0.0))
# generate_story(fused=True) against the per-frame story on the same draws.
# Frame 1 runs the same calls at the same shapes, so it must be equal bit
# for bit. The later frames differ only in the batch of the VAE encoder's
# pass over the history (one frame in the rollout, all the refs at once per
# frame), which may change cuBLAS's algorithm for the VAE attention's
# projections and so the bf16 rounding of the refs' posterior moments; such
# a rounding-level change moves a frame by no more than the models phase
# accepts between two bf16 paths (MODEL_REL_L2, relative L2). A wrong ref,
# caption or draw changes the frame outright.
ROLLOUT_REL_L2 = MODEL_REL_L2


def launches_ok(launches: dict, path: str) -> bool:
    """True if every kernel of `path` launched and no other kernel did."""
    want = PATH_KERNELS[path]
    return all((n > 0) == (k in want) for k, n in launches.items())


def frames_ok(images, shape) -> bool:
    import numpy as np
    return (images.shape == shape and bool(np.isfinite(images).all())
            and images.min() >= 0.0 and images.max() <= 1.0)


def phase_serving(dev, card: str, results: dict) -> bool:
    """Serving's samplers, stages and options at 512 px, bf16, full width,
    on the entry points a user calls: each sampler on one auto-regressive
    frame with 3 refs; stage "multi-image-condition" kernel path against
    plain path, in both conv configurations; ref_feature_interval 2
    against 1; generate_story(fused=True) against the per-frame story; and
    2 images per prompt with a negative prompt."""
    import numpy as np
    import torch
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    refs = np.random.RandomState(7).rand(3, 1, 512, 512, 3).astype(
        np.float32)
    frame = dict(prompt=[PROMPTS[3]], image_prompt=refs,
                 prev_prompt=[[p] for p in PROMPTS[:3]], height=512,
                 width=512, guidance_scale=7.5, image_guidance_scale=3.5)
    ok = True
    for config in ("default", "fused"):
        unet, vae, clip = full_width_models(dev, conv_kernels(config))
        pipe = StoryGenPipeline(unet, vae, clip, token_ids, device=dev)
        if config == "default":
            ok &= serving_samplers(pipe, dev, card, results, frame)
            ok &= serving_interval(pipe, dev, frame)
            ok &= serving_rollout(pipe, card, results)
            ok &= serving_images_per_prompt(pipe, dev, card, frame)
        ok &= serving_mic(pipe, dev, card, results, frame, config)
        del pipe, unet, vae, clip
        torch.cuda.empty_cache()
    return ok


def serving_samplers(pipe, dev, card: str, results: dict, frame: dict
                     ) -> bool:
    """Each sampler once; prints the wall time of its sample() call per
    UNet step (a first call of each sampler, after the story phase warmed
    the kernels)."""
    import torch
    from storygen_tpu_torch.pipeline import frame_generator, timesteps
    walls = []
    sample = pipe.sampler.sample

    def timed_sample(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    pipe.sampler.sample = timed_sample
    ok, total = True, None
    for name, eta in SAMPLER_RUNS:
        reset_launches()
        img = pipe(stage="auto-regressive", num_inference_steps=OPTION_STEPS,
                   sampler=name, eta=eta,
                   generator=frame_generator(dev, 0, 3), **frame)
        launches = read_launches()
        total = launches if total is None else {
            k: n + launches[k] for k, n in total.items()}
        n_iters = len(timesteps(pipe.sampler.sched_cfg, name,
                                OPTION_STEPS).t)
        good = frames_ok(img, (1, 512, 512, 3)) and launches_ok(
            launches, "samplers")
        ok &= good
        print(f"sampler {name}{f' eta {eta}' if eta else ''}: "
              f"auto-regressive frame 512 px, 3 refs, {n_iters} UNet steps: "
              f"{1e3 * walls[-1] / n_iters:.1f} ms per denoise step; range "
              f"[{img.min():.3f}, {img.max():.3f}]; launches F "
              f"{launches['flash_fwd']}, G {launches['geglu_matmul']}, C "
              f"{launches['conv3x3']}, U {launches['upconv3x3']} "
              f"{'ok' if good else 'FAIL'} [{card}]",
              flush=True)
    del pipe.sampler.sample
    return ok & record_launches(results, total, "samplers")


def recorded_sample(pipe, run):
    """Runs `run` while recording what the sampler computes on the way to
    its final latents: the reference latents the VAE encodes, and each UNet
    pass in order, a reference pass as its context maps, a main pass as
    its input latents and its three CFG branches' eps."""
    rec = {"refs": None, "passes": []}
    sampler = pipe.sampler
    encode = sampler.encode_ref_latents

    def encode_recorded(*args, **kwargs):
        out = encode(*args, **kwargs)
        rec["refs"] = out.float().clone()
        return out

    def hook(module, args, output):
        eps, maps = output
        if len(args) > 3 and args[3] is not None:  # (x, t, text, context)
            rec["passes"].append(("main", args[0].float().clone(),
                                  eps.float().clone()))
        else:
            rec["passes"].append(("reference", {
                k: v.float().clone() for k, v in maps.items()}))

    handle = sampler.unet.register_forward_hook(hook)
    sampler.encode_ref_latents = encode_recorded
    try:
        out = run()
    finally:
        handle.remove()
        del sampler.encode_ref_latents
    return out, rec


def mic_carrier_lines(rec_k: dict, rec_p: dict, frame: dict) -> list:
    """Kernel path against plain path, step by step, of two
    `recorded_sample` records of stage "multi-image-condition": the
    encoded reference latents; per step the reference pass's context maps
    (all together, and the map furthest off), the main pass's input
    latents (the latents after the step before), each CFG branch's eps
    and the guided eps."""
    import torch

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    lines = [f"reference latents (VAE encode) rel L2 "
             f"{rel(rec_k['refs'], rec_p['refs']):.3e}"]
    g, gi = frame["guidance_scale"], frame["image_guidance_scale"]
    step = 0
    for pk, pp in zip(rec_k["passes"], rec_p["passes"]):
        if pk[0] == "reference":
            num = sum((pk[1][k] - pp[1][k]).norm() ** 2 for k in pp[1])
            den = sum(pp[1][k].norm() ** 2 for k in pp[1])
            worst = max(pp[1], key=lambda k: rel(pk[1][k], pp[1][k]))
            lines.append(
                f"step {step} reference context ({len(pp[1])} maps) rel L2 "
                f"{(num / den).sqrt().item():.3e}, furthest {worst} "
                f"{rel(pk[1][worst], pp[1][worst]):.3e}")
            continue
        (lat_k, eps_k), (lat_p, eps_p) = pk[1:], pp[1:]
        bk, bp = eps_k.chunk(3), eps_p.chunk(3)

        def guided(e):
            return e[0] + gi * (e[1] - e[0]) + g * (e[2] - e[1])

        branches = ", ".join(f"{n} {rel(x, y):.3e}" for n, x, y in zip(
            ("uncond", "image", "image+text"), bk, bp))
        lines.append(
            f"step {step} main pass: input latents rel L2 "
            f"{rel(lat_k, lat_p):.3e}; eps rel L2 {branches}; guided eps "
            f"{rel(guided(bk), guided(bp)):.3e}")
        step += 1
    return lines


def serving_mic(pipe, dev, card: str, results: dict, frame: dict,
                config: str) -> bool:
    """Stage "multi-image-condition" (one reference pass of (N+1)B rows), 2
    steps, kernel path against plain path on the same draws; where the
    final latents' difference comes from, step by step, on earlier
    lines."""
    import torch
    from storygen_tpu_torch import ops
    from storygen_tpu_torch.pipeline import frame_generator
    path = "mic" if config == "default" else "mic_fused"

    def run():
        _, lat = pipe._generate("multi-image-condition",
                                num_inference_steps=2,
                                generator=frame_generator(dev, 0, 3),
                                **frame)
        return lat.float()

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    lat_k = run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()
    with ops.plain_path():
        lat_p = run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the same two runs again, recorded (outside the timed runs)
    with torch.no_grad():
        _, rec_k = recorded_sample(pipe, run)
        with ops.plain_path():
            _, rec_p = recorded_sample(pipe, run)
        for line in mic_carrier_lines(rec_k, rec_p, frame):
            print(f"[{config}] multi-image-condition carrier: {line} "
                  f"[{card}]", flush=True)
    del rec_k, rec_p
    rel = ((lat_k - lat_p).norm() / lat_p.norm()).item()
    ok = (bool(torch.isfinite(lat_k).all().item()) and rel <= MODEL_REL_L2
          and tuple(lat_k.shape) == (1, 64, 64, 4))
    print(f"[{config}] multi-image-condition 512 px, 3 refs, DDIM-2: final "
          f"latents rel L2 kernel vs plain {rel:.3e} (bound "
          f"{MODEL_REL_L2:.0e}) {'ok' if ok else 'FAIL'}; kernel path "
          f"{1e3 * (t1 - t0):.1f} ms, plain path {1e3 * (t2 - t1):.1f} ms "
          f"[{card}]", flush=True)
    return ok & record_launches(results, launches, path)


def serving_interval(pipe, dev, frame: dict) -> bool:
    """ref_feature_interval 2 at 4 steps runs the reference pass at steps 0
    and 2 only: half the reference passes of interval 1, and half their
    kernel launches."""
    from storygen_tpu_torch.pipeline import frame_generator
    passes = []
    reference_context = pipe.sampler._reference_context

    def counted(*args):
        before = read_launches()
        out = reference_context(*args)
        after = read_launches()
        passes.append({k: after[k] - n for k, n in before.items()})
        return out

    pipe.sampler._reference_context = counted
    runs = {}
    for interval in (1, 2):
        passes.clear()
        img = pipe(stage="auto-regressive", num_inference_steps=OPTION_STEPS,
                   ref_feature_interval=interval,
                   generator=frame_generator(dev, 0, 3), **frame)
        runs[interval] = (len(passes), {k: sum(p[k] for p in passes)
                                        for k in passes[0]}, img)
    del pipe.sampler._reference_context
    (n1, l1, img1), (n2, l2, img2) = runs[1], runs[2]
    ok = (n1 == OPTION_STEPS and n2 == OPTION_STEPS // 2
          and all(l1[k] == 2 * l2[k] and (l2[k] > 0) == (k in SERVING_KERNELS)
                  for k in l1)
          and frames_ok(img1, (1, 512, 512, 3))
          and frames_ok(img2, (1, 512, 512, 3)))
    print(f"ref_feature_interval 1 / 2 at {OPTION_STEPS} steps: {n1} / {n2} "
          f"reference passes; their launches F {l1['flash_fwd']} / "
          f"{l2['flash_fwd']}, G {l1['geglu_matmul']} / "
          f"{l2['geglu_matmul']}, C {l1['conv3x3']} / {l2['conv3x3']}, U "
          f"{l1['upconv3x3']} / {l2['upconv3x3']}; "
          f"frames differ by {abs(img1 - img2).max():.4f} max abs "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def serving_rollout(pipe, card: str, results: dict) -> bool:
    """generate_story(fused=True), the story rollout on cached posterior
    moments, against the per-frame story on the same draws: 3 frames,
    DDIM-4, refs up to 3."""
    import numpy as np
    import torch
    kw = dict(num_inference_steps=OPTION_STEPS, height=512, width=512,
              guidance_scale=7.5, image_guidance_scale=3.5, seed=0)
    prompts = list(PROMPTS[:3])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fused = pipe.generate_story(prompts, fused=True, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()
    per_frame = pipe.generate_story(prompts, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ok = all(frames_ok(f, (512, 512, 3)) for f in fused + per_frame)
    ok &= np.array_equal(fused[0], per_frame[0])
    diffs, rels = [], []
    for a, b in zip(fused, per_frame):
        diffs.append(float(np.abs(a - b).max()))
        rels.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    ok &= all(r <= ROLLOUT_REL_L2 for r in rels)
    print(f"story_rollout (generate_story fused=True) vs per-frame, 3 frames"
          f" 512 px DDIM-{OPTION_STEPS}: max abs diff per frame "
          f"{', '.join(f'{d:.3e}' for d in diffs)}, rel L2 "
          f"{', '.join(f'{r:.3e}' for r in rels)} (frame 1 bitwise, the rest "
          f"rel L2 <= {ROLLOUT_REL_L2:.0e}) {'ok' if ok else 'FAIL'}; fused "
          f"{t1 - t0:.2f} s, per-frame {t2 - t1:.2f} s [{card}]", flush=True)
    ok &= record_launches(results, launches, "rollout")
    return ok & encoder_batch_dependence(pipe.vae, per_frame[:2], card)


def encoder_batch_dependence(vae, frames, card: str) -> bool:
    """Where the VAE encoder's result depends on its batch: the per-frame
    story encodes its history frames together (B = 2 for frame 3), the
    rollout one at a time (B = 1). Two views, module by module:
    - along the chain: every module's output at B = 2 against the two
      B = 1 runs' (forward hooks, in the order the modules finish); the
      first that differs is printed with whether its input was equal;
    - per leaf module: each call of the B = 2 run replayed on its own
      inputs one frame at a time, so each module's own batch dependence
      shows whatever happened upstream; counted per module class.
    False if a module of one of the port's kernels (kernel C's Conv3x3,
    kernel D's strided StridedConv) depends on the batch."""
    import numpy as np
    import torch
    from storygen_tpu_torch.models.layers import Conv3x3, StridedConv
    dev = next(vae.parameters()).device
    x = torch.as_tensor(np.stack(frames), device=dev)
    b = x.shape[0]
    leaves = {m for m in vae.modules() if not list(m.children())}
    records = []

    def clone(v):
        if torch.is_tensor(v):
            return v.detach().clone()
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*map(clone, v))
        if isinstance(v, (tuple, list)):
            return type(v)(map(clone, v))
        if isinstance(v, dict):
            return {k: clone(u) for k, u in v.items()}
        return v

    def row(v, i):
        """Frame i of every batch-major tensor in v."""
        if torch.is_tensor(v):
            return v[i:i + 1] if v.dim() and v.shape[0] == b else v
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(row(u, i) for u in v))
        if isinstance(v, (tuple, list)):
            return type(v)(row(u, i) for u in v)
        if isinstance(v, dict):
            return {k: row(u, i) for k, u in v.items()}
        return v

    def hook(module, args, kwargs, output, name):
        if torch.is_tensor(output):
            keep = module in leaves
            records.append((name, module, clone(args) if keep else None,
                            clone(kwargs) if keep else None,
                            output.detach().clone()))

    handles = [m.register_forward_hook(
        lambda mod, a, kw, o, name=name: hook(mod, a, kw, o, name),
        with_kwargs=True) for name, m in vae.named_modules() if name]
    try:
        with torch.no_grad():
            singles, moments1 = [], []
            for i in range(b):
                records.clear()
                d = vae.encode(x[i:i + 1])
                moments1.append(torch.cat([d.mean, d.logvar], -1))
                singles.append(list(records))
            records.clear()
            d = vae.encode(x)
            pair = list(records)
    finally:
        for h in handles:
            h.remove()
    moments2 = torch.cat([d.mean, d.logvar], -1).float()
    moments1 = torch.cat(moments1).float()
    first = "none"
    for j, (name, module, _, _, out) in enumerate(pair):
        if not torch.equal(out, torch.cat([r[j][4] for r in singles])):
            same_in = pair[j][2] is not None and torch.equal(
                pair[j][2][0], torch.cat([r[j][2][0] for r in singles]))
            first = (f"{name} ({type(module).__name__}), input equal "
                     f"{same_in}")
            break
    per_class: dict = {}
    kernel_dependent = []
    with torch.no_grad():
        for name, module, args, kwargs, out in pair:
            if args is None:
                continue
            alone = torch.cat([module(*row(args, i), **row(kwargs, i))
                               for i in range(b)])
            differs = not torch.equal(alone, out)
            kind = type(module).__name__
            if isinstance(module, StridedConv):
                kind += "(kernel D)" if module.strided else "(F.conv2d)"
            n_diff, n = per_class.get(kind, (0, 0))
            per_class[kind] = (n_diff + differs, n + 1)
            if differs and (isinstance(module, Conv3x3) or (
                    isinstance(module, StridedConv) and module.strided)):
                kernel_dependent.append(name)
    ok = not kernel_dependent
    print(f"VAE encoder batch dependence (frames 1-2 at B = 2 vs one at a "
          f"time): first differing along the chain: {first}; leaf calls "
          f"replayed one frame at a time that differ, by class: "
          f"{json.dumps({k: f'{d}/{n}' for k, (d, n) in per_class.items()})}"
          f"; posterior moments max abs diff "
          f"{(moments2 - moments1).abs().max().item():.3e}, rel L2 "
          f"{(moments2 - moments1).norm().item() / moments1.norm().item():.3e}"
          f" {'ok' if ok else 'FAIL: port kernels depend on the batch: '}"
          f"{', '.join(kernel_dependent)} [{card}]", flush=True)
    return ok


def serving_images_per_prompt(pipe, dev, card: str, frame: dict) -> bool:
    """2 images per prompt with a negative prompt: a batch of 2 in the main
    pass (3-row CFG: 6 rows) and in the reference pass (12 rows)."""
    import numpy as np
    from storygen_tpu_torch.pipeline import frame_generator
    img = pipe(stage="auto-regressive", num_inference_steps=2,
               negative_prompt=["blurry, dark, low quality"],
               num_images_per_prompt=2, generator=frame_generator(dev, 0, 3),
               **frame)
    ok = frames_ok(img, (2, 512, 512, 3)) and not np.array_equal(img[0],
                                                                 img[1])
    print(f"num_images_per_prompt 2, negative prompt: shape {img.shape}, "
          f"range [{img.min():.3f}, {img.max():.3f}] "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    return ok


TRAIN_BATCH, TRAIN_GA = 4, 2
# optimizer steps of the train phase in each configuration
TRAIN_STEPS = {"default": 3, "fused": 1}
# the image side of the train phase's kernel-vs-plain micro-step: its attn3
# spans at the mid block (16 tokens) straddle the flash kernels' 64-row K/V
# tiles
SMALL_SIDE = 256


def stage2_step_vs_plain(dev, card: str, side: int = SMALL_SIDE) -> bool:
    """One stage-2 micro-step at `side` px (batch 4, 3 refs under KEEP, bf16,
    gradient checkpointing) through the trainer's step function, on the
    kernel path and on the plain path from the same weights, batch and
    draws: the loss and the micro-step gradient's norm, and that the kernel
    path launched M, L, DQ and DKV (no fallback to the plain versions)."""
    import torch
    from storygen_tpu_torch import ops
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset, collate
    from storygen_tpu_torch.training import trainer
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_step")
    cfg = TrainConfig(logdir=logdir, train_batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=TRAIN_GA, seed=0,
                      mixed_precision="bf16", remat=True)
    bundle = trainer.build_models(cfg, dev)
    synth = SyntheticStoryDataset(TRAIN_BATCH, size=side, seed=7)
    batch = trainer.to_device(collate([synth[i] for i in range(TRAIN_BATCH)]),
                              dev)
    g = torch.Generator(device=dev).manual_seed(13)
    lat, n = (side // 8, side // 8, 4), 3

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    draws = {"posterior_noise": randn(TRAIN_BATCH, *lat),
             "noise": randn(TRAIN_BATCH, *lat),
             "t": torch.tensor([500, 80, 300, 900], device=dev),
             "ref_posterior_noise": randn(n * TRAIN_BATCH, *lat),
             "ref_noise": randn(TRAIN_BATCH, *lat),
             "ref_mask": torch.tensor(KEEP, dtype=torch.bool, device=dev)}
    # the first micro-step of an accumulation only accumulates, so each
    # path's step leaves the weights as they were
    step_k, _ = trainer.make_stage_step("stage2", cfg, bundle, dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out_k = step_k(batch, g, draws)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()
    with ops.plain_path():
        step_p, _ = trainer.make_stage_step("stage2", cfg, bundle, dev)
        out_p = step_p(batch, g, draws)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lk, lp = out_k["loss"].item(), out_p["loss"].item()
    nk, np_ = out_k["grad_norm"].item(), out_p["grad_norm"].item()
    rel_loss, rel_norm = abs(lk - lp) / abs(lp), abs(nk - np_) / abs(np_)
    backward = ("flash_fwd_masked", "flash_lse", "flash_dq", "flash_dkv",
                "upconv3x3_dx")
    ran = all(launches[k] > 0 for k in backward)
    ok = (ran and math.isfinite(lk) and math.isfinite(nk)
          and rel_loss <= MODEL_REL_L2 and rel_norm <= GRAD_REL_L2)
    print(f"stage-2 micro-step {side}px B{TRAIN_BATCH} 3 refs (attn3 mid "
          f"span {(side // 64) ** 2}): loss kernel {lk:.6f} plain {lp:.6f} "
          f"rel {rel_loss:.3e} (bound {MODEL_REL_L2:.0e}); grad norm kernel "
          f"{nk:.6f} plain {np_:.6f} rel {rel_norm:.3e} (bound "
          f"{GRAD_REL_L2:.0e}); launches M/L/DQ/DKV/UB "
          f"{[launches[k] for k in backward]} {'ok' if ok else 'FAIL'}; "
          f"kernel path {1e3 * (t1 - t0):.1f} ms, plain path "
          f"{1e3 * (t2 - t1):.1f} ms (first calls) [{card}]", flush=True)
    del bundle, step_k, step_p
    torch.cuda.empty_cache()
    return ok


def phase_train(dev, card: str, results: dict,
                config: str = "default") -> bool:
    """The training path: `train("stage2", ...)` through the trainer, on
    seeded synthetic StorySalon-layout batches made up front. In the default
    configuration it first holds a 256 px micro-step's kernel path against
    its plain path (`stage2_step_vs_plain`)."""
    import torch
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset
    from storygen_tpu_torch.training import trainer
    path = "train" if config == "default" else "train_fused"
    steps = TRAIN_STEPS[config]
    ok = stage2_step_vs_plain(dev, card) if config == "default" else True
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", f"chip_smoke_{path}")
    cfg = TrainConfig(logdir=logdir, train_steps=steps,
                      train_batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=TRAIN_GA, seed=0,
                      mixed_precision="bf16", remat=True)
    synth = SyntheticStoryDataset(2 * TRAIN_BATCH, size=512, seed=5)
    dataset = [synth[i] for i in range(len(synth))]  # made before the run
    bundle = trainer.build_models(cfg, dev, conv=conv_kernels(config))
    before = {f"{m}.{n}": p.detach().clone()
              for m in ("unet", "vae", "text_encoder")
              for n, p in bundle[m].named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    state = trainer.train("stage2", cfg, dataset, device=dev,
                          models_bundle=bundle)
    torch.cuda.synchronize()
    launches = read_launches()
    after = {f"{m}.{n}": p.detach()
             for m in ("unet", "vae", "text_encoder")
             for n, p in bundle[m].named_parameters()}
    moved = {k for k in before
             if not torch.equal(after[k].float(), before[k].float())}
    attn3 = {k for k in before if k.startswith("unet.") and "attn3" in k}
    finite = all(math.isfinite(x) for x in state.losses)
    n_micro = steps * TRAIN_GA
    ok &= (finite and len(state.losses) == n_micro and moved == attn3
           and len(attn3) == 16 * 5 and state.optimizer.count == steps)
    steady = state.micro_seconds[1:]
    ms = 1e3 * sum(steady) / len(steady)
    print(f"{path} stage2: {steps} optimizer steps x {TRAIN_GA} "
          f"micro-steps, batch {TRAIN_BATCH}, 512 px, 3 refs, bf16, "
          f"gradient checkpointing; losses "
          f"{', '.join(f'{x:.4f}' for x in state.losses)}; "
          f"{len(moved & attn3)}/{len(attn3)} attn3 tensors moved, "
          f"{len(moved - attn3)} other tensors moved; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"{path}: first micro-step {1e3 * state.micro_seconds[0]:.1f} ms,"
          f" then {ms:.1f} ms per micro-step "
          f"({', '.join(f'{1e3 * s:.1f}' for s in steady)}), "
          f"{1e3 * TRAIN_BATCH / ms:.3f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    ok &= record_launches(results, launches, path)
    del state, bundle, before, after
    torch.cuda.empty_cache()
    return ok

# DDIM steps of the checkpoint phase's story frames
CKPT_STORY_STEPS = 4


def build_dir(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)


def folder_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def phase_checkpoint(dev, card: str, results: dict) -> bool:
    """Checkpoint IO on the card: the full-width seeded bf16 models through
    StoryGenPipeline.save_pretrained and back through
    load_diffusers_pretrained (every tensor equal bit for bit); a 2-frame
    DDIM-4 story from the loaded pipeline against the source pipeline's on
    the same draws (equal bit for bit; it launches F, G, C and U); and a UNet
    file without attn3/norm4 loading with attn3 == attn1, norm4 == norm1."""
    import shutil

    import numpy as np
    import torch
    from storygen_tpu_torch.checkpoint import hf_import
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    root = build_dir("chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    src = StoryGenPipeline(*full_width_models(dev), token_ids, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src.save_pretrained(root)
    save_s = time.perf_counter() - t0
    nbytes = folder_bytes(root)
    t0 = time.perf_counter()
    b = hf_import.load_diffusers_pretrained(root, dev, torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = (("unet", src.sampler.unet), ("vae", src.vae),
             ("text_encoder", src.text_encoder))
    unequal = [f"{k}.{n}" for k, m in pairs
               for n, v in m.state_dict().items()
               if not (b[k].state_dict()[n].dtype == v.dtype
                       and torch.equal(b[k].state_dict()[n], v))]
    n_tensors = sum(len(m.state_dict()) for _, m in pairs)
    ok = not unequal
    print(f"checkpoint: save_pretrained {save_s:.2f} s, {nbytes} bytes "
          f"({nbytes / save_s / 1e9:.3f} GB/s); load_diffusers_pretrained "
          f"onto the card {load_s:.2f} s ({nbytes / load_s / 1e9:.3f} GB/s); "
          f"{n_tensors - len(unequal)}/{n_tensors} tensors equal bit for bit "
          f"{'ok' if ok else 'FAIL ' + str(unequal[:3])} [{card}]",
          flush=True)
    b_unet_config = b["unet_config"]
    loaded = StoryGenPipeline(b["unet"], b["vae"], b["text_encoder"],
                              token_ids, b["scheduler_config"], device=dev)
    kw = dict(num_inference_steps=CKPT_STORY_STEPS, height=512, width=512,
              guidance_scale=7.5, image_guidance_scale=3.5, seed=0)
    want = src.generate_story(list(PROMPTS[:2]), **kw)
    torch.cuda.synchronize()
    reset_launches()
    got = loaded.generate_story(list(PROMPTS[:2]), **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    same = [bool(np.array_equal(a, g)) for a, g in zip(want, got)]
    good = all(same) and len(got) == 2 and frames_ok(np.stack(got),
                                                     (2, 512, 512, 3))
    ok &= good
    print(f"checkpoint: 2-frame DDIM-{CKPT_STORY_STEPS} story from the "
          f"loaded folder vs the source models, same draws: frames equal "
          f"bit for bit {same} {'ok' if good else 'FAIL'}", flush=True)
    ok &= record_launches(results, launches, "checkpoint")
    del loaded, b, src
    torch.cuda.empty_cache()

    # a vanilla SD-1.5 UNet file: no attn3 / norm4 keys
    vanilla = build_dir("chip_smoke_ckpt_vanilla")
    os.makedirs(vanilla, exist_ok=True)
    sd = hf_import.load_state_dict_file(
        os.path.join(root, "unet", "diffusion_pytorch_model.bin"))
    kept = {k: v for k, v in sd.items()
            if ".attn3." not in k and ".norm4." not in k}
    path = os.path.join(vanilla, "diffusion_pytorch_model.bin")
    torch.save(kept, path)
    t0 = time.perf_counter()
    with torch.device("meta"):
        meta = UNet2DConditionModel(b_unet_config)
    unet = hf_import.load_into(
        meta, hf_import.apply_attn3_surgery(hf_import.load_state_dict_file(
            path)), dev, torch.bfloat16)
    torch.cuda.synchronize()
    surgery_s = time.perf_counter() - t0
    state = unet.state_dict()
    filled = [k for k in state if ".attn3." in k or ".norm4." in k]
    wrong = [k for k in filled if not torch.equal(
        state[k], state[k.replace(".attn3.", ".attn1.")
                        .replace(".norm4.", ".norm1.")])]
    good = len(filled) == 112 and not wrong and len(sd) - len(kept) == 112
    ok &= good
    print(f"checkpoint: UNet file without attn3/norm4 ({len(kept)} keys) "
          f"loaded in {surgery_s:.2f} s; {len(filled) - len(wrong)}/"
          f"{len(filled)} filled tensors equal attn1 / norm1 "
          f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
    del unet, state, sd, kept
    shutil.rmtree(vanilla, ignore_errors=True)
    torch.cuda.empty_cache()
    return ok


# train_more: optimizer steps of the stage-1 and COCO runs, and of the
# precomputed stage-2 run (checkpointed after each); each run trains from
# the checkpoint phase's folder
MORE_STEPS = {"stage1": 1, "coco": 1, "precomputed": 2}
STAGE_SUBSET = {"stage1": "attn1", "coco": "attn3", "stage2": "attn3"}


def more_config(name: str, **kw):
    from storygen_tpu_torch.configs import TrainConfig
    return TrainConfig(pretrained_model_path=build_dir("chip_smoke_ckpt"),
                       logdir=build_dir(f"chip_smoke_{name}"),
                       train_batch_size=TRAIN_BATCH,
                       gradient_accumulation_steps=TRAIN_GA, seed=0,
                       mixed_precision="bf16", remat=True, **kw)


def run_stage(stage: str, cfg, dataset, bundle, dev, card: str, **kw):
    """train() on the card from `bundle`: finite losses, only the stage's
    subset moved. Returns (ok, state, launches)."""
    import torch
    from storygen_tpu_torch.training import trainer

    def params():
        return {f"{m}.{n}": p for m in ("unet", "vae", "text_encoder")
                for n, p in bundle[m].named_parameters()}

    before = {k: p.detach().clone() for k, p in params().items()}
    torch.cuda.synchronize()
    reset_launches()
    state = trainer.train(stage, cfg, dataset, device=dev,
                          models_bundle=bundle, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    after = params()
    moved = {k for k in before if not torch.equal(
        after[k].detach().float(), before[k].float())}
    subset = {k for k in before if k.startswith("unet.")
              and STAGE_SUBSET[stage] in k}
    ok = (all(math.isfinite(x) for x in state.losses) and moved == subset
          and len(subset) == 16 * 5
          and state.optimizer.count == cfg.train_steps
          and len(state.losses) == cfg.train_steps * TRAIN_GA)
    steady = state.micro_seconds[1:]
    ms = 1e3 * sum(steady) / len(steady)
    print(f"train_more {stage}{' (precomputed)' if cfg.latents_path else ''}"
          f": {cfg.train_steps} optimizer steps x {TRAIN_GA} micro-steps, "
          f"batch {TRAIN_BATCH}, 512 px, bf16, gradient checkpointing, "
          f"{type(state.optimizer).__name__}; losses "
          f"{', '.join(f'{x:.4f}' for x in state.losses)}; "
          f"{len(moved & subset)}/{len(subset)} {STAGE_SUBSET[stage]} "
          f"tensors moved, {len(moved - subset)} others; first micro-step "
          f"{1e3 * state.micro_seconds[0]:.1f} ms, then {ms:.1f} ms per "
          f"micro-step ({', '.join(f'{1e3 * x:.1f}' for x in steady)}) "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    return ok, state, launches


def write_latents(vae, synth, root: str) -> None:
    """The posterior moments of each synthetic sample's frame and refs,
    encoded by `vae` on the card, as precomputed .npz files (fp16)."""
    import numpy as np
    import torch
    os.makedirs(root, exist_ok=True)
    dev = next(vae.parameters()).device
    for i in range(len(synth)):
        s = synth[i]
        imgs = torch.from_numpy(np.concatenate(
            [s["image"][None], s["ref_images"]])).to(dev)
        with torch.no_grad():
            dist = vae.encode(imgs)
        m = torch.cat([dist.mean, dist.logvar], -1).half().cpu().numpy()
        np.savez(os.path.join(root, f"{i:08d}.npz"), latent_moments=m[0],
                 ref_latent_moments=m[1:], mask=s["mask"].astype(np.float16),
                 input_ids=s["input_ids"], ref_input_ids=s["ref_input_ids"])


def offline_export(dev, card: str, results: dict, ckpt: str,
                   in_loop: str) -> bool:
    """`scripts/export_checkpoint.py` on checkpoint 2 of a run that wrote
    no export itself (in its own process, with no card visible: file work
    alone), against the folder that the uninterrupted run's in-loop export
    wrote at step 2: every tensor equal bit for bit, dtype included, and
    every config file equal; then each folder loaded onto the card and a
    2-frame DDIM-4 story from each on the same draws, equal bit for
    bit."""
    import shutil

    import numpy as np
    import torch
    from storygen_tpu_torch.checkpoint import hf_import
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    out = build_dir("chip_smoke_export")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "storygen_tpu_torch.scripts."
           "export_checkpoint", "--base", build_dir("chip_smoke_ckpt"),
           "--ckpt", ckpt, "--step", "2", "--stage", "stage2", "--out", out]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True)
    export_s = time.perf_counter() - t0
    if run.returncode != 0:
        print(f"export_checkpoint: exit {run.returncode}\n{run.stderr[-2000:]}"
              f" FAIL", flush=True)
        return False
    unequal, n = [], 0
    for sub, fname in (("unet", "diffusion_pytorch_model.bin"),
                       ("vae", "diffusion_pytorch_model.bin"),
                       ("text_encoder", "pytorch_model.bin")):
        a, b = (hf_import.load_state_dict_file(os.path.join(r, sub, fname))
                for r in (out, in_loop))
        n += len(b)
        unequal += [f"{sub}.{k}" for k in sorted(set(a) | set(b))
                    if k not in a or k not in b or a[k].dtype != b[k].dtype
                    or not torch.equal(a[k], b[k])]
    configs = [os.path.join(sub, name) for sub, name in (
        ("unet", "config.json"), ("vae", "config.json"),
        ("text_encoder", "config.json"),
        ("scheduler", "scheduler_config.json"), ("", "model_index.json"))]
    differ = []
    for c in configs:
        with open(os.path.join(out, c)) as f, \
                open(os.path.join(in_loop, c)) as g:
            if f.read() != g.read():
                differ.append(c)
    ok = not unequal and not differ
    print(f"export_checkpoint: step 2 exported offline in {export_s:.2f} s "
          f"(no card visible), {folder_bytes(out)} bytes; "
          f"{n - len(unequal)}/{n} tensors equal the in-loop export's bit "
          f"for bit, dtype included, config files differing {differ} "
          f"{'ok' if ok else 'FAIL ' + str(unequal[:3])} [{card}]",
          flush=True)
    kw = dict(num_inference_steps=CKPT_STORY_STEPS, height=512, width=512,
              guidance_scale=7.5, image_guidance_scale=3.5, seed=0)
    frames = {}
    for name, root in (("in-loop", in_loop), ("offline", out)):
        b = hf_import.load_diffusers_pretrained(root, dev, torch.bfloat16)
        pipe = StoryGenPipeline(b["unet"], b["vae"], b["text_encoder"],
                                token_ids, b["scheduler_config"], device=dev)
        torch.cuda.synchronize()
        reset_launches()
        frames[name] = pipe.generate_story(list(PROMPTS[:2]), **kw)
        torch.cuda.synchronize()
        launches = read_launches()
        del pipe, b
        torch.cuda.empty_cache()
    same = [bool(np.array_equal(a, g))
            for a, g in zip(frames["in-loop"], frames["offline"])]
    good = (all(same) and len(same) == 2
            and frames_ok(np.stack(frames["offline"]), (2, 512, 512, 3)))
    print(f"export_checkpoint: 2-frame DDIM-{CKPT_STORY_STEPS} story from "
          f"the offline export vs the in-loop export, same draws: frames "
          f"equal bit for bit {same} {'ok' if good else 'FAIL'} [{card}]",
          flush=True)
    return ok & good & record_launches(results, launches, "export")


def phase_train_more(dev, card: str, results: dict) -> bool:
    """Training from the checkpoint phase's folder at 512 px, batch 4,
    bf16, gradient checkpointing: stage 1 and COCO; then stage 2 in the
    precomputed-latent mode on .npz files that the loaded VAE encodes on
    the card, with AdamW8bit, a checkpoint after every optimizer step, an
    export and a SampleLogger PNG at step 2; a run resumed from checkpoint
    1 against the uninterrupted one (bit for bit); and the peak memory of
    a step with 8-bit against fp32 moments."""
    import shutil

    import torch
    from storygen_tpu_torch.checkpoint import hf_import
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset
    from storygen_tpu_torch.training import trainer
    synth = SyntheticStoryDataset(2 * TRAIN_BATCH, size=512, seed=5)
    dataset = [synth[i] for i in range(len(synth))]
    ok = True
    for stage in ("stage1", "coco"):
        cfg = more_config(stage, train_steps=MORE_STEPS[stage])
        shutil.rmtree(cfg.logdir, ignore_errors=True)
        bundle = trainer.build_models(cfg, dev)
        good, state, launches = run_stage(stage, cfg, dataset, bundle, dev,
                                          card)
        ok &= good
        ok &= record_launches(results, launches, f"train_{stage}")
        del bundle, state
        torch.cuda.empty_cache()

    # stage 2 on precomputed latents
    lat_dir = build_dir("chip_smoke_latents")
    shutil.rmtree(lat_dir, ignore_errors=True)
    kw = dict(latents_path=lat_dir, use_8bit_adam=True, checkpointing_steps=1,
              export_steps=2, validation_steps=2,
              validation_sample_logger=dict(num_inference_steps=2,
                                            height=512, width=512))
    cfg = more_config("precomputed", train_steps=MORE_STEPS["precomputed"],
                      **kw)
    shutil.rmtree(cfg.logdir, ignore_errors=True)
    bundle = trainer.build_models(cfg, dev)
    t0 = time.perf_counter()
    write_latents(bundle["vae"], synth, lat_dir)
    print(f"train_more: {len(synth)} samples encoded to .npz by the loaded "
          f"VAE in {time.perf_counter() - t0:.2f} s", flush=True)
    val = [{"prompt": PROMPTS[1], "ref_images": dataset[0]["ref_images"],
            "ref_prompts": [PROMPTS[0]] * 3}]
    encodes = []
    encode = bundle["vae"].encode
    bundle["vae"].encode = lambda x: encodes.append(x.shape) or encode(x)
    torch.cuda.reset_peak_memory_stats()
    good, full, launches = run_stage("stage2", cfg, None, bundle, dev, card,
                                     tokenizer=token_ids, val_dataset=val)
    del bundle["vae"].encode
    n_micro = cfg.train_steps * TRAIN_GA
    png = os.path.join(cfg.logdir, "samples", "step2_0.png")
    with open(png, "rb") as f:
        png_ok = f.read(8) == b"\x89PNG\r\n\x1a\n"
    export = os.path.join(cfg.logdir, "checkpoint_2")
    sd = hf_import.load_state_dict_file(
        os.path.join(export, "unet", "diffusion_pytorch_model.bin"))
    export_ok = all(torch.equal(sd[k], p.detach().cpu())
                    for k, p in full.trainable.items())
    ckpts = sorted(os.listdir(trainer.checkpoint_dir(cfg)))
    good &= (png_ok and export_ok and ckpts == ["1", "2"]
             and len(encodes) < n_micro)
    print(f"train_more precomputed: VAE encoder calls {len(encodes)} over "
          f"{n_micro} micro-steps and a validation render (shapes "
          f"{[tuple(x) for x in encodes]}); checkpoints {ckpts}; export "
          f"{folder_bytes(export)} bytes, trained tensors equal {export_ok}; "
          f"SampleLogger PNG {os.path.getsize(png)} bytes {png_ok}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
    ok &= good
    ok &= record_launches(results, launches, "train_precomputed")
    del bundle, sd
    torch.cuda.empty_cache()

    # resumed from checkpoint 1, in a fresh logdir and fresh models, with
    # no in-loop export (export_steps above its steps)
    rcfg = more_config("resumed", train_steps=MORE_STEPS["precomputed"],
                       **{**kw, "export_steps": 3})
    shutil.rmtree(rcfg.logdir, ignore_errors=True)
    shutil.copytree(os.path.join(trainer.checkpoint_dir(cfg), "1"),
                    os.path.join(trainer.checkpoint_dir(rcfg), "1"))
    bundle = trainer.build_models(rcfg, dev)
    resumed = trainer.train("stage2", rcfg, None, device=dev,
                            models_bundle=bundle, tokenizer=token_ids,
                            val_dataset=val)
    diffs = {k: (p.float() - resumed.trainable[k].float()).abs().max().item()
             for k, p in full.trainable.items()}
    worst = max(diffs, key=diffs.get)
    same = (all(torch.equal(p, resumed.trainable[k])
                for k, p in full.trainable.items())
            and resumed.losses == full.losses[TRAIN_GA:])
    ok &= same
    print(f"train_more resume from checkpoint 1: losses "
          f"{', '.join(f'{x:.6f}' for x in resumed.losses)} vs uninterrupted "
          f"{', '.join(f'{x:.6f}' for x in full.losses[TRAIN_GA:])}; "
          f"trained tensors equal bit for bit {same}; largest difference "
          f"{diffs[worst]:.3e} at {worst} {'ok' if same else 'FAIL'} "
          f"[{card}]", flush=True)
    del full, resumed
    ok &= offline_export(dev, card, results, trainer.checkpoint_dir(rcfg),
                         os.path.join(cfg.logdir, "checkpoint_2"))

    # peak memory of one optimizer step: 8-bit against fp32 moments
    peaks = {}
    for eightbit in (True, False):
        pcfg = more_config("peak", latents_path=lat_dir, train_steps=1,
                           use_8bit_adam=eightbit)
        shutil.rmtree(pcfg.logdir, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.train("stage2", pcfg, None, device=dev,
                              models_bundle=bundle, tokenizer=token_ids)
        torch.cuda.synchronize()
        moments = sum(t.numel() * t.element_size()
                      for key in ("mu", "nu")
                      for v in state.optimizer.state_dict()[key].values()
                      for t in (v.values() if isinstance(v, dict) else [v]))
        peaks[eightbit] = (torch.cuda.max_memory_allocated(), moments)
        del state
    print(f"train_more peak memory, one precomputed stage-2 step: AdamW8bit "
          f"{peaks[True][0] / 2**30:.3f} GiB (moments {peaks[True][1]} "
          f"bytes), AdamW {peaks[False][0] / 2**30:.3f} GiB (moments "
          f"{peaks[False][1]} bytes) [{card}]", flush=True)
    ok &= peaks[True][1] < peaks[False][1] / 3
    del bundle
    torch.cuda.empty_cache()
    return ok


# the cli phase: StorySalon stories written (the last held out) and frames
# per story (4 training windows: batch 4); optimizer steps of each training
# run; DDIM steps of the inference story and the served one
CLI_STORIES, CLI_FRAMES = 5, 4
CLI_TRAIN_STEPS = 2
CLI_STORY_STEPS = 4


def timed_main(label: str, fn, card: str):
    """Run fn() on the card: (its result, wall seconds, launches)."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"cli {label}: {wall:.2f} s wall [{card}]", flush=True)
    return out, wall, read_launches()


def phase_cli(dev, card: str, results: dict) -> bool:
    """The port's entry points, called in process through their main(argv)
    at 512 px and full width, from the checkpoint phase's folder: a
    tokenizer written with Tokenizer.save_pretrained; a StorySalon tree of
    512 px PNGs; precompute_latents over it; train stage 2 (2 optimizer
    steps, batch 4) from the images with an export, then from the latents
    with AdamW8bit; inference from the export (a 3-frame DDIM-4 story whose
    PNGs, read back, equal the pipeline's frames for the seed); and serve
    on 127.0.0.1 port 0 (GET /healthz, POST /story of 2 frames). Each
    path's launches and wall time are printed."""
    import base64
    import shutil
    import threading
    import urllib.request

    import numpy as np
    import torch
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.tokenizer import Tokenizer
    from storygen_tpu_torch.scripts import (inference, precompute_latents,
                                            serve, train)
    from storygen_tpu_torch.scripts.common import load_pipeline
    from storygen_tpu_torch.utils.image import decode_png, read_png
    ckpt = build_dir("chip_smoke_ckpt")
    work = build_dir("chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    raw = os.path.join(work, "bpe")
    write_bpe_files(raw, PROMPTS, 400)
    tok = Tokenizer(raw)
    tok.save_pretrained(os.path.join(ckpt, "tokenizer"))
    tok = Tokenizer(os.path.join(ckpt, "tokenizer"))
    ids = tok(list(PROMPTS))
    ok = bool(ids.max() < 49408 and (ids[:, 0] == 49406).all()
              and tok.ids["eos_token"] == 49407 and ids.shape == (4, 77))
    print(f"cli tokenizer: {len(tok.encoder)} tokens, {len(tok.merges)} "
          f"merges, ids < 49408, bos 49406, eos 49407 "
          f"{'ok' if ok else 'FAIL'}", flush=True)

    tree = os.path.join(work, "salon")
    write_storysalon_tree(tree, CLI_STORIES, CLI_FRAMES, 512)
    loader_times(tree, card)
    walls = {}
    lat = os.path.join(work, "latents")
    _, walls["precompute_latents"], launches = timed_main(
        "precompute_latents", lambda: precompute_latents.main(
            ["--ckpt", ckpt, "--dataset", tree, "--out", lat]), card)
    n_lat = len([f for f in os.listdir(lat) if f.endswith(".npz")])
    ok &= n_lat == TRAIN_BATCH
    ok &= record_launches(results, launches, "cli_precompute")

    cfg = dict(pretrained_model_path=ckpt, dataset_path=tree,
               logdir=os.path.join(work, "train_images"),
               train_steps=CLI_TRAIN_STEPS, train_batch_size=TRAIN_BATCH,
               gradient_accumulation_steps=1,
               checkpointing_steps=CLI_TRAIN_STEPS, seed=0,
               mixed_precision="bf16", remat=True, loader_threads=4)
    try:
        import yaml
    except ImportError:
        yaml = None
    path = os.path.join(work, "stage2.yml")

    def train_images():
        if yaml is None:
            return train.run("stage2", TrainConfig(**cfg))
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return train.main(["--stage", "stage2", "--config", path])

    state, walls["train_images"], launches = timed_main(
        "train stage2 from images, " + ("train.run (no PyYAML here)"
                                        if yaml is None else
                                        "train.main --config <YAML>"),
        train_images, card)
    export = os.path.join(cfg["logdir"], f"checkpoint_{CLI_TRAIN_STEPS}")
    good = (len(state.losses) == CLI_TRAIN_STEPS
            and all(math.isfinite(x) for x in state.losses)
            and os.path.isdir(os.path.join(export, "tokenizer")))
    print(f"cli train from images: losses "
          f"{', '.join(f'{x:.4f}' for x in state.losses)}; micro-step s "
          f"(loader wait included) {[round(x, 3) for x in state.micro_seconds]}"
          f"; export "
          f"{folder_bytes(export)} bytes {'ok' if good else 'FAIL'}",
          flush=True)
    ok &= good & record_launches(results, launches, "cli_train")
    del state
    torch.cuda.empty_cache()

    lcfg = TrainConfig(**dict(cfg, logdir=os.path.join(work, "train_latents")),
                       latents_path=lat, use_8bit_adam=True)
    state, walls["train_latents"], launches = timed_main(
        "train stage2 from latents, AdamW8bit",
        lambda: train.run("stage2", lcfg), card)
    good = (len(state.losses) == CLI_TRAIN_STEPS
            and all(math.isfinite(x) for x in state.losses)
            and type(state.optimizer).__name__ == "AdamW8bit")
    print(f"cli train from latents: losses "
          f"{', '.join(f'{x:.4f}' for x in state.losses)}; micro-step s "
          f"{[round(x, 3) for x in state.micro_seconds]} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    ok &= good & record_launches(results, launches, "cli_train_latents")
    del state
    torch.cuda.empty_cache()

    out = os.path.join(work, "story")
    argv = ["--ckpt", export, "--logdir", out, "--num_inference_steps",
            str(CLI_STORY_STEPS), "--seed", "5", "--prompt", *PROMPTS[:3]]
    _, walls["inference"], launches = timed_main(
        "inference", lambda: inference.main(argv), card)
    ok &= record_launches(results, launches, "cli_inference")
    pipe = load_pipeline(export, dev)
    frames = pipe.generate_story(list(PROMPTS[:3]),
                                 num_inference_steps=CLI_STORY_STEPS,
                                 guidance_scale=7.0, seed=5)
    same = [bool(np.array_equal(read_png(os.path.join(
        out, f"story_frame{i}.png")), inference.to_u8(f)))
        for i, f in enumerate(frames)]
    good = len(same) == 3 and all(same)
    print(f"cli inference: 3-frame DDIM-{CLI_STORY_STEPS} story from the "
          f"export; PNGs read back equal the pipeline's frames {same} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    ok &= good
    del pipe
    torch.cuda.empty_cache()

    servers, ready = [], threading.Event()
    thread = threading.Thread(target=serve.main, args=(
        ["--ckpt", export, "--host", "127.0.0.1", "--port", "0"],),
        kwargs=dict(on_ready=lambda srv: (servers.append(srv),
                                          ready.set())), daemon=True)
    t0 = time.perf_counter()
    thread.start()
    good = ready.wait(300)
    walls["serve_start"] = time.perf_counter() - t0
    if good:
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.load(r)
            body = json.dumps({"prompts": list(PROMPTS[:2]), "seed": 1,
                               "num_inference_steps": CLI_STORY_STEPS}
                              ).encode()

            def post():
                with urllib.request.urlopen(urllib.request.Request(
                        base + "/story", body), timeout=600) as r:
                    return json.load(r)

            reply, walls["serve_story"], launches = timed_main(
                "serve POST /story", post, card)
            shapes = [decode_png(base64.b64decode(f)).shape
                      for f in reply["frames"]]
            good = (health == {"ok": True, "devices": 1}
                    and shapes == [(512, 512, 3)] * 2)
            print(f"cli serve: /healthz {health}; /story {len(shapes)} "
                  f"frames {shapes}, latency_s {reply['latency_s']} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            good &= record_launches(results, launches, "cli_serve")
        finally:
            servers[0].shutdown()
            thread.join(60)
    ok &= good and not thread.is_alive()
    rounded = {k: round(v, 2) for k, v in walls.items()}
    print(f"cli walls (s): {json.dumps(rounded)} [{card}]", flush=True)
    torch.cuda.empty_cache()
    return ok


# The dataset phase: YOLOv7's input side, the tolerance of its head maps
# on the card against the CPU, the synthetic video's shape, and the
# inpainting's DDIM steps (the JAX package's default).
YOLO_SIZE = 640
# cuDNN may run fp32 convolutions in TF32 (allow_tf32, on by default),
# which rounds each operand to a 10-bit mantissa (2^-11 relative); the
# port leaves that global flag as PyTorch sets it. The seeded detect
# biases (objectness and class priors near -5) make up most of each raw
# head map (the rest is 0.5-1.2% of its L2), so the check reads what the
# backbone computes: the detect convs' input features, and the head maps
# less their folded bias. Over the 55-71 convs in a row before them the
# roundings add up to 3.2e-4 to 5.1e-4 relative on an H100 (under 4e-6
# with TF32 off); a bf16 or wrong conv gives 1e-2 to O(1). Bound on the
# relative L2 error of each.
YOLO_REL_L2 = 2e-3
VIDEO_SHOTS, VIDEO_SHOT_FRAMES = 3, 20
VIDEO_W, VIDEO_H = 640, 360
INPAINT_STEPS = 25
NATIVE_FRAMES = 16


def yolo_upstream_state(spec, num_classes: int, seed: int) -> dict:
    """A seeded YOLOv7 state_dict in the upstream train form (Conv + BN,
    RepConv's three branches, IDetect's conv and implicit pair) of `spec`:
    conv weights N(0, 2 / fan_in), BN statistics and affines near their
    identity, and the detect biases as upstream's _initialize_biases sets
    them (objectness log(8 / (640 / stride)^2), classes log(0.6 / (nc -
    0.99))), so that few boxes pass a 0.5 confidence."""
    import torch
    from storygen_tpu_torch.detection.yolov7 import (ANCHORS_P5, STRIDES_P5,
                                                     spec_channels)
    g = torch.Generator().manual_seed(seed)
    ch = spec_channels(spec)
    state = {}

    def conv(key, cin, cout, k):
        state[key] = torch.randn(cout, cin, k, k, generator=g) * math.sqrt(
            2.0 / (cin * k * k))

    def bn(key, c):
        state[f"{key}.weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        state[f"{key}.bias"] = 0.1 * torch.randn(c, generator=g)
        state[f"{key}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        state[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=g)
        state[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def conv_bn(key, cin, cout, k):
        conv(f"{key}.conv.weight", cin, cout, k)
        bn(f"{key}.bn", cout)

    na = ANCHORS_P5.shape[1]
    no = num_classes + 5
    for i, e in enumerate(spec):
        p = f"model.{i}"
        if e[0] == "conv":
            conv_bn(p, ch[e[1]], e[2], e[3])
        elif e[0] == "sppcspc":
            cin, c_ = ch[e[1]], e[2]
            for j, (a, b, k) in enumerate(
                    ((cin, c_, 1), (cin, c_, 1), (c_, c_, 3), (c_, c_, 1),
                     (4 * c_, c_, 1), (c_, c_, 3), (2 * c_, c_, 1)), 1):
                conv_bn(f"{p}.cv{j}", a, b, k)
        elif e[0] == "repconv":
            cin, cout = ch[e[1]], e[2]
            conv(f"{p}.rbr_dense.0.weight", cin, cout, 3)
            bn(f"{p}.rbr_dense.1", cout)
            conv(f"{p}.rbr_1x1.0.weight", cin, cout, 1)
            bn(f"{p}.rbr_1x1.1", cout)
            if cin == cout:
                bn(f"{p}.rbr_identity", cin)
        elif e[0] == "detect":
            for j, f in enumerate(e[1]):
                state[f"{p}.m.{j}.weight"] = 0.01 * torch.randn(
                    na * no, ch[f], 1, 1, generator=g)
                b = 0.01 * torch.randn(na, no, generator=g)
                b[:, 4] += math.log(8 / (640 / STRIDES_P5[j]) ** 2)
                b[:, 5:] += math.log(0.6 / (num_classes - 0.99))
                state[f"{p}.m.{j}.bias"] = b.reshape(-1)
                state[f"{p}.ia.{j}.implicit"] = 0.02 * torch.randn(
                    1, ch[f], 1, 1, generator=g)
                state[f"{p}.im.{j}.implicit"] = 1 + 0.02 * torch.randn(
                    1, na * no, 1, 1, generator=g)
    return state


def write_story_video(path: str, shots: int, frames_per_shot: int,
                      width: int, height: int, seed: int = 0) -> None:
    """An MJPG video of `shots` shots, each a colour ramp with a ripple
    along its own direction (a third of a turn from the last shot's) and a
    line of white overlay text, its frames differing by seeded grain: cuts
    that the keyframe detector finds, the classical dedup embedder keeps
    apart and the classical text detector masks."""
    import cv2
    import numpy as np
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                        (width, height))
    if not w.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for shot in range(shots):
        ang = 2 * np.pi * shot / 3
        s = (xx - width / 2) * np.cos(ang) + (yy - height / 2) * np.sin(ang)
        f = 110 + 60 * s / np.abs(s).max() + 30 * np.sin(2 * np.pi * s / 60)
        base = np.ascontiguousarray(np.clip(np.stack(
            [f, f * 0.8 + 20, 140 - f * 0.3], -1), 0, 255).astype(np.uint8))
        cv2.putText(base, f"CHAPTER {shot + 1}: THE FOX", (20, height - 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.0, (245, 245, 245), 2)
        for _ in range(frames_per_shot):
            w.write(np.clip(base.astype(int) + rs.randint(-4, 5, base.shape),
                            0, 255).astype(np.uint8))
    w.release()


def timed_ms(fn, iters: int) -> float:
    """Host-clock ms per call of a host function, after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def dataset_native(card: str) -> bool:
    """The native library: its g++ build into a fresh directory, and on
    16 frames of 512 px each function bit for bit against its numpy form,
    with ms per call of both."""
    import shutil

    import numpy as np
    from storygen_tpu_torch import native
    root = build_dir("chip_smoke_native")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    native.build(root)
    build_s = time.perf_counter() - t0
    native.load()
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (512, 512, 3)).astype(np.uint8)
              for _ in range(NATIVE_FRAMES)]
    batch = np.stack(frames)
    pairs = {
        "normalize_u8": (lambda: native.normalize_u8(batch, 2 / 255, -1.0),
                         lambda: native.normalize_u8_numpy(batch, 2 / 255,
                                                           -1.0)),
        "assemble_batch": (lambda: native.assemble_batch(frames, 1 / 255, 0.0),
                           lambda: native.assemble_batch_numpy(
                               frames, 1 / 255, 0.0)),
        "resize_bilinear": (
            lambda: [native.resize_bilinear(f, 384, 640) for f in frames],
            lambda: [native.resize_bilinear_numpy(f, 384, 640)
                     for f in frames])}
    ok = True
    for name, (lib_fn, np_fn) in pairs.items():
        same = all(np.array_equal(a, b) for a, b in
                   zip(np.atleast_1d(lib_fn()), np.atleast_1d(np_fn())))
        ok &= same
        print(f"dataset native {name} (16 x 512x512x3"
              f"{', to 384x640' if name == 'resize_bilinear' else ''}): "
              f"equal bit for bit to the numpy form "
              f"{'ok' if same else 'FAIL'}; per call native "
              f"{timed_ms(lib_fn, 5):.3f} ms, numpy {timed_ms(np_fn, 3):.3f}"
              f" ms", flush=True)
    print(f"dataset native: g++ build {build_s:.2f} s [{card}]", flush=True)
    return ok


def dataset_yolo(dev, card: str, path: str) -> bool:
    """YOLOv7 at full P5 width, fp32, 640 px: a seeded upstream train-form
    checkpoint written to `path` and loaded by load_torch_state and the
    importer; the card's detect inputs and head maps less their bias
    against the same module on the CPU; the NMS of one decoded tensor on
    the card and on the CPU; ms per detect."""
    import numpy as np
    import torch
    from storygen_tpu_torch.detection import yolov7 as Y
    state = yolo_upstream_state(Y.YOLOV7_P5_SPEC, 80, 7)
    torch.save({"model": state}, path)
    t0 = time.perf_counter()
    sd = Y.import_yolov7_params(Y.load_torch_state(path))
    import_s = time.perf_counter() - t0
    cpu = Y.YOLOv7()
    cpu.load_state_dict(sd, strict=True)
    cpu.eval()
    gpu = Y.YOLOv7()
    gpu.load_state_dict(sd, strict=True)
    gpu = gpu.to(dev).eval()
    frame = np.random.RandomState(1).randint(0, 256, (512, 512, 3)).astype(
        np.uint8)
    x = torch.from_numpy(Y.letterbox(frame, YOLO_SIZE)[0])[None]
    d = next(i for i, e in enumerate(Y.YOLOV7_P5_SPEC) if e[0] == "detect")
    heads = [f"m{d}_{j}" for j in range(3)]
    feats = {}
    for model in (gpu, cpu):
        for h in heads:  # the detect convs' inputs, as they run
            model.layers[h].register_forward_pre_hook(
                lambda mod, args, key=(id(model), h):
                feats.__setitem__(key, args[0]))
    with torch.no_grad():
        maps_g = gpu(x.to(dev))
        maps_c = cpu(x)

    def rel(a, b):
        return ((a.cpu() - b).norm() / b.norm()).item()
    rel_f = [rel(feats[id(gpu), h], feats[id(cpu), h]) for h in heads]
    bias = [cpu.layers[h].bias.detach() for h in heads]
    rel_m = [rel(g.cpu() - b, c - b) for g, c, b in zip(maps_g, maps_c, bias)]
    share = [((c - b).norm() / c.norm()).item()
             for c, b in zip(maps_c, bias)]
    ok = max(rel_f + rel_m) <= YOLO_REL_L2 and all(
        bool(torch.isfinite(g).all()) for g in maps_g)
    print(f"dataset yolov7: full P5 width fp32 at {tuple(x.shape)}: "
          f"{sum(p.numel() for p in gpu.parameters())} parameters, imported"
          f" in {import_s:.2f} s; card vs CPU rel L2 of the detect inputs "
          f"{', '.join(f'{r:.3e}' for r in rel_f)}, of the head maps "
          f"{[tuple(m.shape) for m in maps_g]} less their bias "
          f"{', '.join(f'{r:.3e}' for r in rel_m)} (bound "
          f"{YOLO_REL_L2:.0e}; cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}; the maps less their bias are"
          f" {', '.join(f'{s:.3f}' for s in share)} of the maps' L2) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    pred = Y.decode_boxes(maps_g)[0]
    kept = []
    for p in (pred, pred.cpu()):
        boxes, score, cls, valid = Y.nms(p, conf_thres=0.0)
        kept.append((boxes[valid].cpu(), score[valid].cpu(),
                     cls[valid].cpu()))
    top = torch.topk((pred[:, 5:] * pred[:, 4:5]).max(-1).values, 300)
    ties = 300 - len(torch.unique(top.values))
    same = all(torch.equal(a, b) for a, b in zip(*kept))
    ok &= same and len(kept[0][0]) > 0
    print(f"dataset yolov7: NMS of one decoded tensor ({len(pred)} rows, "
          f"{ties} ties among the 300 best scores), conf 0: card keeps "
          f"{len(kept[0][0])}"
          f" boxes, CPU {len(kept[1][0])}, same boxes, scores and classes "
          f"in the same order {'ok' if same else 'FAIL'}", flush=True)
    detect = Y.yolov7_person_detector(path, device=dev)
    boxes = detect(frame)
    ms = timed_ms(lambda: detect(frame), 10)
    print(f"dataset yolov7: detect (letterbox, forward, NMS) on a 512x512 "
          f"frame {ms:.2f} ms, {len(boxes)} person boxes at conf 0.5 "
          f"[{card}]", flush=True)
    return ok


def dataset_inpaint(dev, card: str, results: dict, ckpt: str,
                    kept_for_profiling: dict) -> bool:
    """Inpainting at 512 px with the default 25 DDIM steps and a
    rectangular mask, from the checkpoint folder, in both conv
    configurations: the unmasked latents equal to latents0 bit for bit,
    the pixels outside the mask equal to the input, the kernel path
    against the plain path on the same draws, each configuration's
    launches, ms per denoise step and s per frame. The default
    configuration's latents call goes into `kept_for_profiling`."""
    import numpy as np
    import torch
    from storygen_tpu_torch import ops
    from storygen_tpu_torch.checkpoint.hf_import import (
        load_diffusers_pretrained)
    from storygen_tpu_torch.data.tokenizer import Tokenizer
    from storygen_tpu_torch.data_process.inpaint import Inpainter, latent_mask
    from storygen_tpu_torch.scripts.common import tokenizer_folder
    tok = Tokenizer(tokenizer_folder(ckpt))
    rs = np.random.RandomState(2)
    image = rs.rand(512, 512, 3).astype(np.float32)
    mask = np.zeros((512, 512), np.float32)
    mask[100:300, 60:412] = 1.0
    outside = mask == 0
    ok = True
    for config in ("default", "fused"):
        b = load_diffusers_pretrained(ckpt, dev, torch.bfloat16,
                                      conv_kernels(config))
        inp = Inpainter(b["unet"], b["vae"], device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        post = torch.randn((1, 64, 64, 4), generator=g, device=dev)
        noise = torch.randn((1, 64, 64, 4), generator=g, device=dev)
        out = inp.inpaint_image(b["text_encoder"], tok, image, mask,
                                prompt=PROMPTS[0], posterior_noise=post,
                                latent_noise=noise)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = inp.inpaint_image(b["text_encoder"], tok, image, mask,
                                prompt=PROMPTS[0], posterior_noise=post,
                                latent_noise=noise)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        path = "inpaint" if config == "default" else "inpaint_fused"
        good = (out.shape == (512, 512, 3) and bool(np.isfinite(out).all())
                and bool(np.array_equal(out[outside], image[outside])))
        ok &= good & record_launches(results, read_launches(), path)
        # the latents, kernel path and plain path on the same inputs
        with torch.no_grad():
            lat0 = b["vae"].encode(torch.as_tensor(
                image, device=dev)[None] * 2 - 1).sample(post) * (
                    b["vae"].config.scaling_factor)
            text = b["text_encoder"](torch.as_tensor(
                tok([PROMPTS[0]]), dtype=torch.long, device=dev))
        m = latent_mask(torch.as_tensor(mask, device=dev), (64, 64))

        def latents(steps=INPAINT_STEPS, inp=inp, lat0=lat0, m=m, text=text,
                    noise=noise):
            return inp.inpaint_latents(lat0, m, text, noise,
                                       num_inference_steps=steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat_k = latents()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / INPAINT_STEPS
        kept = m == 0
        exact = bool(torch.equal(lat_k[kept.expand_as(lat_k)],
                                 lat0[kept.expand_as(lat0)]))
        line = (f"dataset inpaint [{config}]: 512x512, DDIM-{INPAINT_STEPS},"
                f" mask {int(mask.sum())} px ({int(m.sum())} latent px): "
                f"{frame_s:.3f} s per frame, {step_ms:.2f} ms per denoise "
                f"step; unmasked latents equal latents0 bit for bit {exact}, "
                f"pixels outside the mask equal the input {good}")
        with ops.plain_path():
            lat_p = latents()
        masked = m.bool().expand_as(lat_k)
        rel = ((lat_k[masked] - lat_p[masked]).norm()
               / lat_p[masked].norm()).item()
        good = rel <= MODEL_REL_L2 and bool(torch.isfinite(lat_k).all())
        ok &= exact and good
        print(f"{line}; masked latents kernel vs plain path rel L2 {rel:.3e}"
              f" (bound {MODEL_REL_L2:.0e}) {'ok' if good else 'FAIL'} "
              f"[{card}]", flush=True)
        if config == "default":
            kept_for_profiling["latents"] = latents
        del inp, b
        torch.cuda.empty_cache()
    return ok


def dataset_build(dev, card: str, results: dict, ckpt: str,
                  yolo: str) -> bool:
    """scripts.build_dataset.main on a synthetic video (shot changes and
    overlay text), stages extract, dedup, mask, inpaint and align on the
    card: keyframes, a mask per kept frame, and each inpainted frame equal
    to its keyframe (resized to 512 px, as the stage reads it) wherever
    its mask is 0. The caption stage is not run: no image-to-text
    checkpoint ships with the repository."""
    import importlib.util
    import shutil

    import numpy as np
    import torch
    from PIL import Image
    from storygen_tpu_torch.data_process import extract
    from storygen_tpu_torch.scripts import build_dataset
    work = build_dir("chip_smoke_dataset")
    shutil.rmtree(work, ignore_errors=True)
    videos = os.path.join(work, "videos")
    os.makedirs(videos)
    write_story_video(os.path.join(videos, "story1.avi"), VIDEO_SHOTS,
                      VIDEO_SHOT_FRAMES, VIDEO_W, VIDEO_H)
    originals = extract.extract_keyframes(os.path.join(videos, "story1.avi"),
                                          os.path.join(work, "keyframes"))
    out = os.path.join(work, "out")
    argv = ["--videos", videos, "--out", out, "--stages",
            "extract,dedup,mask,inpaint,align", "--ckpt", ckpt,
            "--yolo_weights", yolo, "--device", "cuda"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    build_dataset.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    img_dir = os.path.join(out, "image_inpainted_finally_checked", "story1")
    mask_dir = os.path.join(out, "mask", "story1")
    frames = sorted(os.listdir(img_dir))
    masks = sorted(os.listdir(mask_dir))
    checks = []
    for orig in originals:
        name = os.path.basename(orig)
        if name not in frames:
            continue
        src = np.asarray(Image.open(orig).convert("RGB").resize((512, 512)),
                         np.float32) / 255.0
        m = np.asarray(Image.open(os.path.join(mask_dir, name)).convert("L")
                       .resize((512, 512)), np.float32) / 255.0
        got = np.asarray(Image.open(os.path.join(img_dir, name)))
        if m.max() == 0:  # nothing to inpaint: the keyframe as it was
            same = bool(np.array_equal(got, np.asarray(Image.open(orig))))
            checks.append((name, 0.0, same, 0))
            continue
        # the stage's own arithmetic: uint8 / 255, composite, * 255
        want = (src * 255).astype(np.uint8)
        keep = m == 0
        same = bool(np.array_equal(got[keep], want[keep]))
        changed = int((got[~keep] != want[~keep]).any(-1).sum())
        checks.append((name, float(m.mean()), same, changed))
    good = (len(originals) == VIDEO_SHOTS and frames == masks
            and len(checks) == len(frames) >= 2
            and all(c[2] for c in checks) and any(c[3] > 0 for c in checks))
    print(f"dataset build_dataset: {len(originals)} keyframes, {len(frames)}"
          f" kept, masks {masks}; per frame (mask share, equal outside the "
          f"mask, changed px inside) {checks} {'ok' if good else 'FAIL'}; "
          f"wall {wall:.2f} s [{card}]", flush=True)
    good &= record_launches(results, launches, "dataset_build")
    print("dataset build_dataset: caption stage not run: no image-to-text "
          "checkpoint ships with the repository, and a seeded one would "
          "exercise transformers' BLIP more than the port; the CPU tests "
          "hold data_process/caption.py against the JAX package (this "
          "host has transformers: "
          f"{importlib.util.find_spec('transformers') is not None})",
          flush=True)
    return good


def dataset_profiling(card: str, kept: dict) -> bool:
    """utils/profiling on the card, with the inpaint part's default
    inpainter: trace() around one inpainting step annotated "inpaint_step"
    writes a trace holding that range; StepTimer over 5 one-step calls;
    and a trace of the main path's 25-step latents call, whose kernels'
    busy time over the same call's untraced wall is the device's busy
    share (1 - idle)."""
    import glob
    import shutil

    import torch
    from storygen_tpu_torch.utils.profiling import StepTimer, annotate, trace
    latents = kept["latents"]

    def traced(name, fn):
        logdir = build_dir(f"chip_smoke_trace_{name}")
        shutil.rmtree(logdir, ignore_errors=True)
        with trace(logdir):
            with annotate(name):
                fn()
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        events = []
        for f in files:
            with open(f) as fh:
                events += json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        found = len(files) == 1 and any(e.get("name") == name
                                        for e in events)
        return found, len(kernels), sum(e.get("dur", 0)
                                        for e in kernels) / 1e3

    def step():
        return latents(1)
    step()
    found, n_step, busy_step = traced("inpaint_step", step)
    timer = StepTimer()
    for _ in range(5):
        with timer:
            timer.block_on(step())
    st = timer.stats(skip_first=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latents()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    found_all, n_all, busy_all = traced("inpaint_latents", latents)
    ok = found and found_all and n_step > 0 and st["n"] == 5
    print(f"dataset profiling: trace of one inpainting step ({n_step} "
          f"device kernels, {busy_step:.2f} ms busy) holds the annotate "
          f"range {found}; StepTimer over 5 one-step calls p50 "
          f"{1e3 * st['p50_s']:.2f} ms, p90 {1e3 * st['p90_s']:.2f} ms; "
          f"the {INPAINT_STEPS}-step latents call: {wall_ms:.2f} ms "
          f"untraced, traced {n_all} device kernels {busy_all:.2f} ms busy "
          f"(range held {found_all}): device idle "
          f"{1 - busy_all / wall_ms:.3f} of the call "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    kept.clear()
    torch.cuda.empty_cache()
    return ok


def phase_dataset(dev, card: str, results: dict) -> bool:
    """The dataset-building path on the card (data_process/, detection/,
    native/, utils/profiling and scripts/build_dataset.py), from the
    checkpoint phase's folder with the cli phase's tokenizer."""
    import torch
    ckpt = build_dir("chip_smoke_ckpt")
    yolo = build_dir("chip_smoke_yolov7.pt")
    # the kernels phase turned TF32 off for its library yardsticks; this
    # phase runs as a user's process does, with PyTorch's default
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    ok = True
    kept: dict = {}
    for name, part in (
            ("native", lambda: dataset_native(card)),
            ("yolov7", lambda: dataset_yolo(dev, card, yolo)),
            ("inpaint", lambda: dataset_inpaint(dev, card, results, ckpt,
                                                kept)),
            ("build_dataset", lambda: dataset_build(dev, card, results, ckpt,
                                                    yolo)),
            ("profiling", lambda: dataset_profiling(card, kept))):
        t0 = time.perf_counter()
        good = part()
        ok &= good
        print(f"dataset {name}: {time.perf_counter() - t0:.1f} s "
              f"{'ok' if good else 'FAIL'}", flush=True)
    torch.backends.cudnn.allow_tf32 = tf32
    return ok


# The quality phase: the StorySalon tree (4 training windows for batch 4,
# one held-out window), the chain's steps, the COCO-val candidates, and the
# card-vs-CPU bound of the scorer's embeddings. The scorer runs in fp32;
# its patch conv (K = 3 * 32 * 32) runs in cuDNN with PyTorch's TF32
# default, which rounds both operands to 10 mantissa bits (2^-11 relative):
# over 3072 terms of mixed sign that is ~1e-4 of a patch embedding, and the
# 12 pre-LN layers carry it at about that size to the pooled class token.
# The text tower has no conv (its matmuls stay fp32), so its embeddings
# differ by the order of fp32 sums alone, ~1e-6 after 12 layers.
QUALITY_STORIES, QUALITY_FRAMES = 5, 4
QUALITY_COCO_STEPS = 4
SCORER_IMAGE_REL_L2 = 5e-3
SCORER_TEXT_REL_L2 = 1e-4
# run_quality on the trainer's final export against the suite's exact pass
# on the stage-1 export with that state swapped in: the same weights, so
# the same scores up to float noise (abs, on each mean and window)
SWAP_SCORE_ABS = 1e-6
# what each step of the quality phase must launch: the chain trains stage
# 1 and stage 2 (and precomputes with the VAE encoder, renders with F, G,
# C); run_quality, COCO-val and study_knobs render; compare_quality is
# numpy
PATH_KERNELS.update({
    "quality_chain": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS),
    "quality_run": SERVING_KERNELS,
    "quality_compare": (),
    "quality_coco": SERVING_KERNELS,
    "quality_knobs": SERVING_KERNELS,
})


def quality_step(label: str, fn, card: str, results: dict, path: str):
    """Run one step of the quality phase on the card: (its result, wall
    seconds, whether its launches are the path's)."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"quality {label}: {wall:.2f} s wall [{card}]", flush=True)
    good = record_launches(results, launches, path)
    torch.cuda.empty_cache()
    return out, wall, good


def quality_configs(work: str, ckpt: str) -> tuple:
    """Copies of configs/stage{1,2}_tpu_smoke.yml that name the checkpoint
    folder and its tokenizer (the committed ones name a tokenizer outside
    the repository), at batch 4 with 2 micro-steps per optimizer step
    (theirs: 8 and 24) to keep the phase short."""
    import yaml
    root = os.path.dirname(os.path.abspath(__file__))
    out = []
    for stage in (1, 2):
        with open(os.path.join(root, "configs",
                               f"stage{stage}_tpu_smoke.yml")) as f:
            cfg = yaml.safe_load(f)
        cfg.update(pretrained_model_path=ckpt,
                   tokenizer_path=os.path.join(ckpt, "tokenizer"),
                   train_batch_size=TRAIN_BATCH,
                   gradient_accumulation_steps=TRAIN_GA, loader_threads=4)
        out.append(os.path.join(work, f"stage{stage}_smoke.yml"))
        with open(out[-1], "w") as f:
            yaml.safe_dump(cfg, f)
    return tuple(out)


def phase_quality(dev, card: str, results: dict) -> bool:
    """The evaluation layer and the quality scripts on the card, called in
    process through each script's main(argv), from the checkpoint phase's
    full-width folder with the cli phase's tokenizer: run_chain (stage 1,
    precompute, stage 2 from the stage-1 export, the suite's DDIM-40 and
    dpm++-25 passes at states 1 and 2, chain.json), run_quality on the
    chain's final export (its scores those of the suite's exact pass on
    the swapped-in state), compare_quality on the suite's exact and
    dpm++-25 / interval-2 JSONs, COCO-val with PickScore re-ranking (its
    pick equal to the argmax of PickScorer.score on the same candidates),
    study_knobs at full width, and the scorer on the card against the
    same scorer on the CPU on the generated PNGs."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image
    from storygen_tpu_torch.data.datasets import COCOValMultiSegDataset
    from storygen_tpu_torch.evaluation.clip_scores import (CLIPScorer,
                                                           PickScorer)
    from storygen_tpu_torch.scripts import (compare_quality,
                                            inference_coco_val,
                                            make_synth_coco,
                                            make_synth_storysalon, run_chain,
                                            run_quality, study_knobs)
    from storygen_tpu_torch.scripts.common import load_pipeline
    ckpt = build_dir("chip_smoke_ckpt")
    work = build_dir("chip_smoke_quality")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # the kernels phase turned TF32 off for its library yardsticks; the
    # scorers run as a user's process does, with PyTorch's default
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    data, root = os.path.join(work, "salon"), os.path.join(work, "chain")
    make_synth_storysalon.write(data, QUALITY_STORIES, QUALITY_FRAMES, 512, 1)
    stage1_yml, stage2_yml = quality_configs(work, ckpt)
    ok, walls = True, {}

    summary, walls["run_chain"], good = quality_step(
        "run_chain (stage 1, precompute, stage 2, suite)",
        lambda: run_chain.main([
            "--root", root, "--data", data, "--stage1_steps", "1",
            "--steps", "2", "--ckpt_every", "1", "--score_steps", "2",
            "--stage1_config", stage1_yml, "--stage2_config", stage2_yml]),
        card, results, "quality_chain")
    tags = ("exact_s1", "dpm25_ri2_s1", "exact_s2", "dpm25_ri2_s2",
            "dpm25_s2")
    runs = {t: os.path.join(root, f"quality_{t}.json") for t in tags}
    written = {t: os.path.exists(p) for t, p in runs.items()}
    passes = list(summary["quality_curve"].values()) + list(
        summary["fast_points"].values())
    good &= (all(written.values()) and os.path.exists(
        os.path.join(root, "chain.json"))
        and all(r is not None and r["num_windows"] == 1 for r in passes)
        and os.path.isdir(os.path.join(root, "train", "checkpoint_2")))
    with open(runs["exact_s2"]) as f:
        exact = json.load(f)
    print(f"quality run_chain: suite JSONs {written}; loss curve "
          f"{summary['loss_curve']}; exact_s2 keys {sorted(exact)}; clip_i "
          f"{exact['clip_i']:.6f}, clip_t {exact['clip_t']:.6f}, pickscore "
          f"{exact['pickscore']:.6f}, clip_fid {exact['clip_fid']} (one "
          f"window: no covariance) {'ok' if good else 'FAIL'}", flush=True)
    ok &= good

    metrics, walls["run_quality"], good = quality_step(
        "run_quality --skip_train --ckpt_step 2", lambda: run_quality.main([
            "--root", root, "--data", data, "--skip_train", "--ckpt_step",
            "2", "--stories", str(QUALITY_STORIES), "--frames",
            str(QUALITY_FRAMES), "--test-stories", "1"]),
        card, results, "quality_run")
    keys = ("clip_i", "clip_t", "pickscore")
    swap_err = max(abs(a - b) for k in keys for a, b in zip(
        [metrics[k]] + metrics["per_window"][k],
        [exact[k]] + exact["per_window"][k]))
    good &= (sorted(metrics) == sorted(exact)
             and all(math.isfinite(metrics[k]) for k in keys)
             and swap_err <= SWAP_SCORE_ABS)
    print(f"quality run_quality: keys {sorted(metrics)}; clip_i "
          f"{metrics['clip_i']:.6f}, pickscore {metrics['pickscore']:.6f}; "
          f"against the suite's exact_s2 (state swapped into the stage-1 "
          f"export) max abs {swap_err:.3e} (bound {SWAP_SCORE_ABS:.0e}) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    ok &= good

    res, walls["compare_quality"], good = quality_step(
        "compare_quality exact_s2 vs dpm25_ri2_s2",
        lambda: compare_quality.main([runs["exact_s2"],
                                      runs["dpm25_ri2_s2"]]),
        card, results, "quality_compare")
    good &= (res["fast_config"]["sampler"] == "dpm++"
             and res["exact_config"]["num_inference_steps"] == 40
             and isinstance(res["certified"], bool))
    print(f"quality compare_quality: keys {sorted(res)}; certified "
          f"{res['certified']} {'ok' if good else 'FAIL'}", flush=True)
    ok &= good

    scorer_dir = os.path.join(root, "clip_scorer")
    coco, coco_out = os.path.join(work, "coco"), os.path.join(work, "coco_out")
    make_synth_coco.write(coco, 1, 512, "val2017")
    kept, walls["inference_coco_val"], good = quality_step(
        "inference_coco_val with PickScore", lambda: inference_coco_val.main([
            "--ckpt", ckpt, "--coco_root", coco, "--logdir", coco_out,
            "--pickscore_processor", scorer_dir, "--pickscore_model",
            scorer_dir, "--num_samples", "2", "--samples_per_batch", "2",
            "--num_inference_steps", str(QUALITY_COCO_STEPS)]),
        card, results, "quality_coco")
    sample = COCOValMultiSegDataset(coco)[0]
    name = os.path.basename(sample["image_path"])
    pipe = load_pipeline(ckpt, dev)
    cands = inference_coco_val.candidates(pipe, sample, 0, 2, 2,
                                          QUALITY_COCO_STEPS)
    del pipe
    scores = PickScorer(scorer_dir, scorer_dir, dev).score(
        sample["prompt"], [Image.fromarray(c) for c in cands])
    want = os.path.join(work, "want.jpg")
    Image.fromarray(cands[int(np.argmax(scores))]).save(want)
    with open(want, "rb") as f, open(os.path.join(coco_out, name), "rb") as g:
        same = f.read() == g.read()
    good &= kept == {name: int(np.argmax(scores))} and same
    print(f"quality inference_coco_val: PickScores {scores.tolist()}, kept "
          f"{kept}, argmax {int(np.argmax(scores))}, the written file is "
          f"that candidate: {same} {'ok' if good else 'FAIL'}", flush=True)
    ok &= good
    torch.cuda.empty_cache()

    knobs, walls["study_knobs"], good = quality_step(
        "study_knobs (full width, 512 px, bf16)",
        lambda: study_knobs.main([]), card, results, "quality_knobs")
    good &= (list(knobs) == [c[0] for c in study_knobs.CONFIGS]
             and knobs["exact_ddim50"]["latent_rel_rmse_vs_exact"] == 0.0
             and all(math.isfinite(v) for r in knobs.values()
                     for v in r.values()))
    print(f"quality study_knobs: {json.dumps(knobs)} "
          f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
    ok &= good
    ok &= quality_scorer(root, scorer_dir, dev, card)
    torch.backends.cudnn.allow_tf32 = tf32
    print(f"quality walls (s): "
          f"{json.dumps({k: round(v, 2) for k, v in walls.items()})} "
          f"[{card}]", flush=True)
    return ok


def quality_scorer(root: str, scorer_dir: str, dev, card: str) -> bool:
    """The seeded ViT-B/32 scorer on the card against the same folder on
    the CPU, on the generated and ground-truth PNGs (image embeddings) and
    the captions and prompts (text embeddings), and its ms per image at
    batch 1 and 8 (preprocessing included)."""
    import glob

    import numpy as np
    import torch
    from PIL import Image
    from storygen_tpu_torch.evaluation.clip_scores import CLIPScorer
    paths = sorted(glob.glob(os.path.join(root, "gen*", "*.png"))
                   + glob.glob(os.path.join(root, "gt", "*.png")))
    imgs = [Image.open(p).convert("RGB") for p in paths]
    texts = list(PROMPTS)
    for p in sorted(glob.glob(os.path.join(root, "captions", "*.txt"))):
        with open(p) as f:
            texts.append(f.read())
    card_scorer = CLIPScorer(scorer_dir, dev)
    cpu_scorer = CLIPScorer(scorer_dir, "cpu")
    img_err = rel_l2(card_scorer.image_features(imgs).cpu(),
                     cpu_scorer.image_features(imgs))
    txt_err = rel_l2(card_scorer.text_features(texts).cpu(),
                     cpu_scorer.text_features(texts))
    batch8 = (imgs * 8)[:8]
    ms = {}
    for n in (1, 8):
        card_scorer.image_embed(batch8[:n])  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            card_scorer.image_embed(batch8[:n])
        torch.cuda.synchronize()
        ms[n] = (time.perf_counter() - t0) * 1e3 / 5 / n
    good = (len(imgs) >= 6 and img_err <= SCORER_IMAGE_REL_L2
            and txt_err <= SCORER_TEXT_REL_L2)
    print(f"quality scorer: card vs CPU on {len(imgs)} PNGs and "
          f"{len(texts)} texts: image embeddings rel L2 {img_err:.3e} "
          f"(bound {SCORER_IMAGE_REL_L2:.0e}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}), text {txt_err:.3e} (bound "
          f"{SCORER_TEXT_REL_L2:.0e}); ms per image (preprocessing "
          f"included) batch 1 {ms[1]:.3f}, batch 8 {ms[8]:.3f} "
          f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
    del card_scorer
    torch.cuda.empty_cache()
    return good


# The parallel phase. (a) 2 micro-steps of each training run; (b) DDIM
# steps of the TP story's 2 frames; each part's rank processes must end
# within RANKS_TIMEOUT seconds.
PAR_TRAIN_STEPS = 2
TP_STORY_STEPS = 4
TP_SIDE = 512  # px of (b)'s story frames and UNet pass
RANKS_TIMEOUT = 400
# all-reduces of a full-width UNet pass under tensor parallelism: one per
# row-parallel site, 16 transformer blocks x (attn1, attn2, FF, and attn3
# in the image cycle) + 22 resnet conv2
TP_REDUCES = {"reference": 16 * 3 + 22, "main": 16 * 4 + 22}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case: str, world: int, dev, **kw) -> list:
    """`world` spawned processes on the device `dev` (all on one card),
    joined over gloo through a file store under build/, each running
    RANK_CASES[case](rank, world, dev, **kw); their results in rank order.
    A rank that fails, or a part that outlasts RANKS_TIMEOUT, raises (the
    processes are killed). The kernels are built before: the ranks load
    the library from disk."""
    import multiprocessing
    import shutil

    import torch
    work = build_dir(f"chip_smoke_ranks_{case}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.save(dict(kw, device=str(dev)), os.path.join(work, "args.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(case, r, world, work))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + RANKS_TIMEOUT
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 1))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        raise RuntimeError(f"{case}: {len(hung)} rank(s) hung past "
                           f"{RANKS_TIMEOUT} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{case}: rank exit codes {codes}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rank_main(case: str, rank: int, world: int, work: str) -> None:
    """One rank process of run_ranks: gloo over a file store."""
    import torch
    import torch.distributed as dist
    from storygen_tpu_torch.ops import _build
    kw = torch.load(os.path.join(work, "args.pt"), weights_only=False)
    dev = torch.device(kw.pop("device"))
    torch.cuda.set_device(dev)
    _build.load()  # built by the parent: found on disk
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, "store"), rank=rank, world_size=world)
    try:
        out = RANK_CASES[case](rank, world, dev, **kw)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_story_rank(rank, world, dev, prompts, kw):
    """The TP story: generate_story with the UNet sharded over the ranks
    (VAE and CLIP replicated); frames, launches and wall time."""
    import torch
    from storygen_tpu_torch.parallel import tensor as T
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    unet, vae, clip = full_width_models(dev)
    tp = T.shard_unet_params(unet, T.make_tp_mesh(1, world))
    pipe = StoryGenPipeline(unet, vae, clip, token_ids, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.generate_story(prompts, **kw)
    torch.cuda.synchronize()
    return {"frames": frames, "wall": time.perf_counter() - t0,
            "launches": read_launches(), "reduces": tp.allreduces}


def tp_pass_rank(rank, world, dev, inputs, config):
    """One reference pass and one image-cycle pass of the sharded UNet in
    conv configuration `config`: eps, launches and each pass's
    all-reduces."""
    import torch
    from storygen_tpu_torch.parallel import tensor as T
    unet = full_width_models(dev, conv_kernels(config))[0]
    tp = T.shard_unet_params(unet, T.make_tp_mesh(1, world))
    torch.cuda.synchronize()
    reset_launches()
    eps, reduces = unet_passes(unet, inputs, dev, tp)
    torch.cuda.synchronize()
    return {"eps": eps, "launches": read_launches(), "reduces": reduces}


def unet_passes(unet, inputs, dev, tp=None):
    """models_vs_plain's image cycle: a reference pass over 3 refs (6
    rows), then the main pass (3 CFG rows); eps on the CPU and, with `tp`,
    the all-reduces of each pass."""
    import torch
    from storygen_tpu_torch.pipeline import StoryGenSampler
    x = {k: v.to(dev) for k, v in inputs.items()}
    reduces = {}
    with torch.no_grad():
        n0 = tp.allreduces if tp else 0
        _, raw = unet(x["refs"], x["t_ref"], x["rtext"])
        reduces["reference"] = (tp.allreduces if tp else 0) - n0
        ctx = {k: StoryGenSampler._expand(v, 3, 1) for k, v in raw.items()}
        n0 = tp.allreduces if tp else 0
        eps = unet(x["x"], 481, x["text"], ctx)[0].float().cpu()
        reduces["main"] = (tp.allreduces if tp else 0) - n0
    return eps, reduces


def dp_train_rank(rank, world, dev, steps, seed):
    """Stage-2 micro-steps of the full-width models at batch 2 per rank,
    the gradients averaged over the ranks (mesh.make_mesh): losses, grad
    norms, the attn3 parameters before and after, launches and wall."""
    import torch
    from storygen_tpu_torch.parallel import mesh as M
    return dp_train(dev, M.make_mesh(world), steps, seed)


def dp_train(dev, mesh, steps: int, seed: int) -> dict:
    """`steps` stage-2 micro-steps (optimizer steps, no accumulation) of
    the global batch of TRAIN_BATCH seeded 512 px samples, this rank's
    rows of it (all without a mesh), the draws from one seeded generator
    (the global batch's on every rank)."""
    import torch
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset, collate
    from storygen_tpu_torch.parallel import mesh as M
    from storygen_tpu_torch.training import trainer
    cfg = TrainConfig(train_batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=1, seed=seed,
                      mixed_precision="bf16", remat=True)
    bundle = trainer.build_models(cfg, dev)
    synth = SyntheticStoryDataset(TRAIN_BATCH, size=512, seed=seed)
    batch = collate([synth[i] for i in range(TRAIN_BATCH)])
    if mesh is not None:
        batch = M.shard_batch(batch, mesh)
    batch = trainer.to_device(batch, dev)
    step, opt = trainer.make_stage_step("stage2", cfg, bundle, dev,
                                        mesh=mesh)
    before = {k: p.detach().float().to("cpu", copy=True)
              for k, p in opt.params.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics = [step(batch, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"loss": [m["loss"].item() for m in metrics],
            "grad_norm": [m["grad_norm"].item() for m in metrics],
            "before": before, "launches": read_launches(), "wall": wall,
            "after": {k: p.detach().float().cpu()
                      for k, p in opt.params.items()}}


RANK_CASES = {"tp_story": tp_story_rank, "tp_pass": tp_pass_rank,
              "dp_train": dp_train_rank}


def rel_l2(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def parallel_nccl_world1(card: str, results: dict) -> bool:
    """(a) scripts.train.main on stage 2 from the checkpoint phase's
    folder and the cli phase's 512 px tree, without and with the three
    flags at world size 1 over NCCL, in turns (plain, NCCL, NCCL, plain):
    losses and updated attn3 parameters equal bit for bit."""
    import torch
    import yaml
    from storygen_tpu_torch.scripts import train
    work = build_dir("chip_smoke_parallel")
    os.makedirs(work, exist_ok=True)
    runs, ok = [], True
    for i, nccl in enumerate((False, True, True, False)):
        cfg = dict(pretrained_model_path=build_dir("chip_smoke_ckpt"),
                   dataset_path=os.path.join(build_dir("chip_smoke_cli"),
                                             "salon"),
                   logdir=os.path.join(work, f"run{i}"),
                   train_steps=PAR_TRAIN_STEPS, train_batch_size=TRAIN_BATCH,
                   gradient_accumulation_steps=1, checkpointing_steps=1000,
                   seed=0, mixed_precision="bf16", remat=True,
                   loader_threads=4)
        path = os.path.join(work, f"run{i}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        argv = ["--stage", "stage2", "--config", path]
        if nccl:
            argv += ["--coordinator", f"127.0.0.1:{free_port()}",
                     "--num_processes", "1", "--process_id", "0"]
        label = "NCCL world 1" if nccl else "plain"
        state, wall, launches = timed_main(f"parallel (a) train {label}",
                                           lambda: train.main(argv), card)
        ok &= not torch.distributed.is_initialized()  # main left the group
        runs.append((nccl, list(state.losses), list(state.micro_seconds),
                     {k: v.detach().cpu() for k, v in
                      state.trainable.items()}, wall))
        if i == 1:
            ok &= record_launches(results, launches, "nccl_train")
        del state
        torch.cuda.empty_cache()
    plain = [r for r in runs if not r[0]]
    same = []
    for r in runs:
        same.append(r[1] == plain[0][1] and all(
            torch.equal(r[3][k], plain[0][3][k]) for k in plain[0][3]))
    good = all(same) and len(plain[0][3]) == 16 * 5
    ok &= good
    for nccl, losses, secs, _, wall in runs:
        print(f"parallel (a) {'NCCL world 1' if nccl else 'plain       '}: "
              f"losses {', '.join(f'{x:.6f}' for x in losses)}; micro-step "
              f"ms {', '.join(f'{1e3 * s:.1f}' for s in secs)}; wall "
              f"{wall:.2f} s [{card}]", flush=True)
    print(f"parallel (a): losses and {len(plain[0][3])} attn3 tensors equal "
          f"bit for bit to the first plain run {same} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return ok


def parallel_kernels_at_shards(dev, card: str) -> bool:
    """The kernels at the shapes a TP = 2 shard gives them at the UNet's
    first level (512 px, CFG batch 3), each against its plain version
    (kernel_vs_plain): F with 4 heads at d 40, G at N 640 and E 320, C at
    Cout 160 and at Cin 160 with Cout 320, P at Cin 160 with 16 groups."""
    import torch
    from storygen_tpu_torch.models.layers import GroupNorm
    from storygen_tpu_torch.ops import route
    from storygen_tpu_torch.ops.attention import multi_head_attention
    from storygen_tpu_torch.ops.conv import (conv3x3, conv3x3_plain,
                                             gnconv3x3, gnconv3x3_plain)
    from storygen_tpu_torch.ops.geglu import geglu_matmul, geglu_matmul_plain
    g = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    b, s = 3, 4096
    q, k, v = (randn(b, s, 160) for _ in range(3))
    proj, w_ff, b_ff = randn(b * s, 1280), randn(320, 640, scale=0.04), \
        randn(320).float()
    x320, x160 = randn(b, 64, 64, 320), randn(b, 64, 64, 160)
    w_c1, w_c2 = randn(9, 320, 160, scale=0.02), randn(9, 160, 320,
                                                       scale=0.03)
    bias160, bias320 = randn(160).float(), randn(320).float()
    res = randn(b, 64, 64, 320)
    gn = GroupNorm(16, 160).to(dev)
    a, sh = gn.fold(x160)
    ok = kernel_vs_plain(
        "parallel (b) F at a TP=2 shard: attn1 L1 B3 4096^2, 4 heads d40",
        lambda: multi_head_attention(q, k, v, 4), (b, s, 160), card)
    ok &= kernel_vs_plain(
        "parallel (b) G at a TP=2 shard: L1 ff (12288, 2x640) -> E 320",
        lambda: route(geglu_matmul, geglu_matmul_plain)(proj, w_ff, b_ff,
                                                        s),
        (b * s, 320), card)
    ok &= kernel_vs_plain(
        "parallel (b) C at a TP=2 shard: conv1 L1 64^2 320 -> Cout 160",
        lambda: route(conv3x3, conv3x3_plain)(x320, w_c1, bias160),
        (b, 64, 64, 160), card)
    ok &= kernel_vs_plain(
        "parallel (b) C at a TP=2 shard: conv2 L1 64^2 Cin 160 -> 320 "
        "+ residual", lambda: route(conv3x3, conv3x3_plain)(
            x160, w_c2, bias320, res), (b, 64, 64, 320), card)
    ok &= kernel_vs_plain(
        "parallel (b) P at a TP=2 shard: conv2 L1 Cin 160, 16 groups -> "
        "320 + residual", lambda: route(gnconv3x3, gnconv3x3_plain)(
            x160, w_c2, bias320, a, sh, res), (b, 64, 64, 320), card)
    return ok


def parallel_tp(dev, card: str, results: dict) -> bool:
    """(b) TP = 2 on two ranks sharing cuda:0 over gloo: a 2-frame
    auto-regressive DDIM-4 story at 512 px (max 3 refs) and one fused
    image-cycle UNet pass, each against one process on the same weights
    and draws (rel L2 <= MODEL_REL_L2 per frame and for eps), the
    all-reduces of each pass against the layout (TP_REDUCES), the paths'
    launches, and the kernels at the shard shapes."""
    import numpy as np
    import torch
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    kw = dict(num_inference_steps=TP_STORY_STEPS, height=TP_SIDE,
              width=TP_SIDE, guidance_scale=7.5, image_guidance_scale=3.5,
              seed=0, max_refs=3)
    prompts = list(PROMPTS[:2])
    pipe = StoryGenPipeline(*full_width_models(dev), token_ids, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pipe.generate_story(prompts, **kw)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    del pipe
    unet = full_width_models(dev, conv_kernels("fused"))[0]
    g, lat = torch.Generator().manual_seed(11), TP_SIDE // 8
    d = unet.config.cross_attention_dim
    inputs = {"refs": torch.randn((6, lat, lat, 4), generator=g),
              "rtext": torch.randn((6, 77, d), generator=g),
              "x": torch.randn((3, lat, lat, 4), generator=g),
              "text": torch.randn((3, 77, d), generator=g),
              "t_ref": torch.tensor([48, 48, 32, 32, 16, 16])}
    eps_one, _ = unet_passes(unet, inputs, dev)
    del unet
    torch.cuda.empty_cache()
    ok = True
    t0 = time.perf_counter()
    story = run_ranks("tp_story", 2, dev, prompts=prompts, kw=kw)
    story_wall = time.perf_counter() - t0
    passes = run_ranks("tp_pass", 2, dev, inputs=inputs, config="fused")
    for rank, (out, fused) in enumerate(zip(story, passes)):
        rels = [rel_l2(f, w) for f, w in zip(out["frames"], want)]
        finite = all(bool(np.isfinite(f).all()) for f in out["frames"])
        rel_eps = rel_l2(fused["eps"], eps_one)
        good = (finite and len(rels) == 2 and max(rels) <= MODEL_REL_L2
                and rel_eps <= MODEL_REL_L2
                and fused["reduces"] == TP_REDUCES)
        ok &= good
        print(f"parallel (b) rank {rank}: TP=2 story frames rel L2 vs one "
              f"process {', '.join(f'{r:.3e}' for r in rels)} (bound "
              f"{MODEL_REL_L2:.0e}); fused image-cycle pass eps rel L2 "
              f"{rel_eps:.3e}; all-reduces per pass {fused['reduces']} "
              f"(layout {TP_REDUCES}), story {out['reduces']}; story wall "
              f"{out['wall']:.2f} s (two processes time-sliced on one card; "
              f"one process {one_wall:.2f} s) {'ok' if good else 'FAIL'} "
              f"[{card}]", flush=True)
        ok &= record_launches(results, out["launches"], f"tp_story_r{rank}")
        ok &= record_launches(results, fused["launches"],
                              f"tp_fused_pass_r{rank}")
    print(f"parallel (b): spawn to results {story_wall:.1f} s [{card}]",
          flush=True)
    return ok & parallel_kernels_at_shards(dev, card)


def parallel_dp(dev, card: str, results: dict) -> bool:
    """(c) DP = 2 on two ranks sharing cuda:0 over gloo: stage-2
    micro-steps at batch 2 per rank against one process at batch 4 on the
    same global batch and draws: losses, grad norms and the attn3 updates
    within GRAD_REL_L2 (PyTorch's GroupNorm sums in a batch-dependent
    order, so not bit for bit)."""
    import torch
    one = dp_train(dev, None, PAR_TRAIN_STEPS, 3)
    torch.cuda.empty_cache()
    ranks = run_ranks("dp_train", 2, dev, steps=PAR_TRAIN_STEPS, seed=3)
    ok = True
    upd_one = torch.cat([(one["after"][k] - one["before"][k]).flatten()
                         for k in one["after"]])
    for rank, out in enumerate(ranks):
        upd = torch.cat([(out["after"][k] - out["before"][k]).flatten()
                         for k in one["after"]])
        rel_upd = rel_l2(upd, upd_one)
        rel_loss = max(abs(a - b) / abs(b) for a, b in zip(out["loss"],
                                                             one["loss"]))
        rel_norm = max(abs(a - b) / abs(b) for a, b in zip(
            out["grad_norm"], one["grad_norm"]))
        good = (all(math.isfinite(x) for x in out["loss"])
                and max(rel_upd, rel_loss, rel_norm) <= GRAD_REL_L2)
        ok &= good
        print(f"parallel (c) rank {rank}: DP=2 B2/rank vs one process B4, "
              f"{PAR_TRAIN_STEPS} micro-steps: losses "
              f"{', '.join(f'{x:.6f}' for x in out['loss'])} vs "
              f"{', '.join(f'{x:.6f}' for x in one['loss'])} (max rel "
              f"{rel_loss:.3e}); grad norm max rel {rel_norm:.3e}; attn3 "
              f"update rel L2 {rel_upd:.3e} (bound {GRAD_REL_L2:.0e}); wall "
              f"{out['wall']:.2f} s (two processes time-sliced on one "
              f"card; one process {one['wall']:.2f} s) "
              f"{'ok' if good else 'FAIL'} [{card}]", flush=True)
        ok &= record_launches(results, out["launches"], f"dp_train_r{rank}")
    return ok


def phase_parallel(dev, card: str, results: dict) -> bool:
    """parallel/: (a) NCCL at world size 1 equal to the plain trainer,
    (b) TP = 2 and (c) DP = 2 on two gloo ranks sharing the card."""
    ok = parallel_nccl_world1(card, results)
    ok &= parallel_tp(dev, card, results)
    ok &= parallel_dp(dev, card, results)
    return ok


# the study phase's full-width shapes: (B, H, Sq, Skv, d)
STUDY_SHAPES = {"attn3 L1": (3, 8, 4096, 12288, 40),
                "attn1 L1": (6, 8, 4096, 4096, 40),
                "attn3 L2": (3, 8, 1024, 3072, 80),
                "attn3 L3": (3, 8, 256, 768, 160)}


def study_path() -> None:
    """Drives every ported study entry point once, on the card, at one of
    that study's own UNet shapes, 2 timed calls per candidate."""
    from storygen_tpu_torch.studies import (bench_attn_ablate,
                                            bench_attn_bnd2, bench_attn_int8,
                                            bench_attn_int8_epilogue,
                                            bench_attn_multihead,
                                            bench_attn_scan, bench_attn_v2,
                                            bench_attn_variants)
    for run, shape in (
            (bench_attn_variants.main, "attn1_L1_main"),
            (bench_attn_v2.main, "attn3_L2"),
            (bench_attn_scan.main, "attn3_L2"),
            (bench_attn_scan.main_bounded, "attn3_L2"),
            (bench_attn_scan.main_pair, "attn3_L2"),
            (bench_attn_ablate.main, "attn1_L1_ref"),
            (bench_attn_bnd2.main, "attn3_L2"),
            (bench_attn_multihead.main, "attn3_L2"),
            (bench_attn_multihead.main, "attn3_L3"),
            (bench_attn_int8.main, "attn1_L1_ref"),
            (bench_attn_int8_epilogue.main, "attn1_L1")):
        run(shapes=[shape], iters=2)


def study_cases(dev):
    """Each study wrapper at the studies' full-width shapes, over the knobs
    its study sweeps: (Case, rtol). The oracle is the wrapper's plain
    version on the same inputs; the library call is SDPA where the function
    computes attention."""
    import torch
    from storygen_tpu_torch.ops import study_attention as sa, study_int8 as si
    from storygen_tpu_torch.studies import common
    from storygen_tpu_torch.studies.bench_attn_int8 import int8_study_inputs
    inputs = {}

    def qkv(shape):
        if shape not in inputs:
            inputs[shape] = common.qkv(dev, *STUDY_SHAPES[shape], seed=4)
        return inputs[shape]

    def tag(shape, **kw):
        b, _, sq, skv, d = STUDY_SHAPES[shape]
        return (f"{shape} B{b} {sq}x{skv} d{d} "
                + " ".join(f"{k}={v}" for k, v in kw.items()))

    cases = []
    for w, shape, kw in (
            (sa.variant_attention, "attn3 L1",
             dict(bq=64, bk=64, fold_scale=False, use_exp2=False)),
            (sa.variant_attention, "attn3 L1",
             dict(bq=128, bk=64, fold_scale=True, use_exp2=True)),
            (sa.variant_attention, "attn1 L1",
             dict(bq=128, bk=128, fold_scale=True, use_exp2=True,
                  split2=True)),
            (sa.variant_attention, "attn3 L2",
             dict(bq=128, bk=64, fold_scale=True, use_exp2=False)),
            (sa.t_attention, "attn3 L2", dict(bq=64, bk=128)),
            (sa.t_attention, "attn3 L3", dict(bq=64, bk=64, use_exp2=True)),
            (sa.tb_attention, "attn3 L1", dict(bq=128, bk=64)),
            (sa.tb_attention, "attn1 L1", dict(bq=64, bk=64)),
            (sa.tb_attention, "attn3 L2", dict(bq=64, bk=128)),
            (sa.tb_attention, "attn3 L3", dict(bq=128, bk=128)),
            (sa.bounded_attention, "attn3 L1", dict(bq=128, bk=64)),
            (sa.bounded_attention, "attn3 L2", dict(bq=64, bk=64)),
            (sa.bounded_multi_attention, "attn3 L1",
             dict(bq=128, bk=64, sub=2)),
            (sa.bounded_multi_attention, "attn3 L2",
             dict(bq=64, bk=64, sub=4)),
            (sa.ablate_attention, "attn3 L1",
             dict(bq=64, bk=64, do_exp=False, do_pv=False)),
            (sa.ablate_attention, "attn3 L1",
             dict(bq=64, bk=64, do_exp=True, do_pv=False)),
            (sa.ablate_attention, "attn3 L1",
             dict(bq=64, bk=64, do_exp=False, do_pv=True)),
            (sa.ablate_attention, "attn1 L1",
             dict(bq=128, bk=128, do_exp=True, do_pv=True, halves=2)),
            (sa.bnd2_attention, "attn3 L1", dict(bq=128, bk=64)),
            (sa.bnd2_attention, "attn3 L2", dict(bq=128, bk=128)),
            (sa.mh_attention, "attn3 L3", dict(g=2)),
            (sa.mh_attention, "attn3 L2", dict(g=4)),
            (sa.mh_attention, "attn1 L1", dict(g=8)),
            (sa.mh_attention, "attn3 L3", dict(g=8)),
            # the ablation split beside F (ABLATION_SPLIT): QK, QK_EXP,
            # QK_PV and TB at F's BK at d 40
            *((sa.ablate_attention, shape,
               dict(bq=128, bk=128, do_exp=e, do_pv=p))
              for shape in ("attn3 L1", "attn1 L1")
              for e, p in ((False, False), (True, False), (False, True),
                           (True, True)))):
        q, k, v = qkv(shape)
        b, h, sq, skv, d = STUDY_SHAPES[shape]
        sm = d ** -0.5
        n = float(b * h * sq * skv * d)
        pv = kw.get("do_pv", True)
        attention = pv and kw.get("do_exp", True)
        # one exp a logit, but where the ablation edits it out
        exps = float(b * h * sq * skv) if kw.get("do_exp", True) else 0.0
        cases.append((Case(
            w.__name__, tag(shape, **kw),
            lambda w=w, q=q, k=k, v=v, sm=sm, kw=kw: w(q, k, v, sm_scale=sm,
                                                       **kw),
            lambda w=w, q=q, k=k, v=v, sm=sm, kw=kw: w.plain(
                q, k, v, sm_scale=sm, **kw), None,
            (lambda q=q, k=k, v=v, sm=sm: common.sdpa(q, k, v, sm))
            if attention else None,
            (4.0 if pv else 2.0) * n,
            2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d), exps=exps),
            KERNEL_RTOL))

    # int8 work counted at the bf16 rate it is equivalent to
    i8 = PEAK_FLOPS / PEAK_INT8
    q, k, v = qkv("attn3 L1")
    b, h, sq, skv, d = STUDY_SHAPES["attn3 L1"]
    n = float(b * h * sq * skv * d)
    q_t, kf, q_t8, k8 = int8_study_inputs(q, k)
    # S3 in int8 and bf16 (k's rows of whole 32-byte sectors: int8 at 64
    # bytes, bf16 copied into 48 zero-padded columns in the call), and bf16
    # on a view of zero-padded rows, whose padding the wrapper cannot
    # vouch for, so that its map is D wide and its rows end mid-sector
    kview = si.padded_rows(kf, 48)
    for int8, qt_, k_, extra in ((True, q_t8, k8, {}), (False, q_t, kf, {}),
                                 (False, q_t, kview, {"k": "view48"})):
        kw = dict(bq=128, bk=64, int8=int8)
        eb = 1.0 if int8 else 2.0
        cases.append((Case(
            "qk_only", tag("attn3 L1", **kw, **extra),
            lambda a=qt_, c=k_, kw=kw: si.qk_only(a, c, **kw),
            lambda a=qt_, c=k_, kw=kw: si.qk_only.plain(a, c, **kw), None,
            None, 2.0 * n * (i8 if int8 else 1.0),
            eb * b * h * d * (sq + skv) + 4.0 * b * h * sq,
            yardstick=lambda: torch.bmm(kf, q_t)),
            INT8_SUM_RTOL if int8 else KERNEL_RTOL))
    # S4 at bq 128 (two consumer warpgroups, ping-pong) and 64 (one); one
    # exp a logit
    for shape, kw in (("attn3 L1", dict(bq=128, bk=64)),
                      ("attn1 L1", dict(bq=64, bk=64)),
                      ("attn1 L1", dict(bq=128, bk=128))):
        q, k, v = qkv(shape)
        b, h, sq, skv, d = STUDY_SHAPES[shape]
        sm, n = d ** -0.5, float(b * h * sq * skv * d)
        cases.append((Case(
            "full_int8", tag(shape, **kw),
            lambda q=q, k=k, v=v, sm=sm, kw=kw: si.full_int8(
                q, k, v, sm_scale=sm, **kw),
            lambda q=q, k=k, v=v, sm=sm, kw=kw: si.full_int8.plain(
                q, k, v, sm_scale=sm, **kw), None,
            lambda q=q, k=k, v=v, sm=sm: common.sdpa(q, k, v, sm),
            2.0 * n * i8 + 2.0 * n,
            2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d),
            exps=float(b * h * sq * skv)), KERNEL_RTOL))
    q, k, v = qkv("attn3 L1")
    b, h, sq, skv, d = STUDY_SHAPES["attn3 L1"]
    sm, n = d ** -0.5, float(b * h * sq * skv * d)
    q8, sqr = si.quant_rows(q)
    k8, skr = si.quant_rows(k)
    args = (q8, sqr, k8, skr, v)
    kw = dict(bq=128, bk=128)
    cases.append((Case(
        "int8_attn_from_quant", tag("attn3 L1", **kw),
        lambda a=args, kw=kw: si.int8_attn_from_quant(*a, sm_scale=sm, **kw),
        lambda a=args, kw=kw: si.int8_attn_from_quant.plain(
            *a, sm_scale=sm, **kw), None,
        lambda: common.sdpa(q, k, v, sm), 2.0 * n * i8 + 2.0 * n,
        b * h * d * (sq + skv) + 4.0 * b * h * (sq + skv)
        + 2.0 * (b * h * skv * d + b * h * sq * d),
        exps=float(b * h * sq * skv)), KERNEL_RTOL))
    return cases


def study_ptxas() -> bool:
    """The registers and spill bytes that ptxas gave every S1-S4
    instantiation in this run's build, one line each (wg_ptxas); False if
    any instantiation spills, ptxas serialises a wgmma, or a built line
    has no report."""
    from storygen_tpu_torch.ops import study_attention as sa, study_int8 as si
    # S1: online_wg_kernel<DP, WGM, BK, STAGES, KPW, MODE, HALVES>
    ok = wg_ptxas("study_online", "online_wg_kernel",
                  {(dp, bq // 64, bk, st, kpw, mode, halves)
                   for (dp, bq, bk, mode, halves), (st, kpw)
                   in sa.ONLINE_BUILT.items()})
    # S2: bounded_wg_kernel<DP, BQ, BK, SUB, HALVES, G, KIND, STAGES, KPW>
    for stem, bnd2 in (("study_bounded", False), ("study_bnd2", True)):
        ok &= wg_ptxas(stem, "bounded_wg_kernel",
                       {key + line for key, line in sa.BOUNDED_BUILT.items()
                        if (key[6] == sa.BND2) == bnd2})
    # S3: qk_wg_kernel<I8, BQ, BK, STAGES, KPW>
    ok &= wg_ptxas("study_qk", "qk_wg_kernel",
                   {(i8, bq, bk) + line
                    for (i8, _, bq, bk), line in si.QK_BUILT.items()})
    # S4: int8_wg_kernel<BQ, BK, STAGES, KPW>
    ok &= wg_ptxas("study_int8", "int8_wg_kernel",
                   {(bq, bk) + line
                    for (_, _, bq, bk), line in si.INT8_BUILT.items()})
    return ok


def int8_sass() -> None:
    """The int-to-float conversions (I2F, I2FP) and the exp2s (MUFU.EX2)
    in the SASS of every S4 instantiation of this run's build (cuobjdump
    -sass of the library): S4 takes one exp2 a logit, so conversions over
    exp2s is the conversions a logit."""
    import re
    from pathlib import Path
    from storygen_tpu_torch.ops import _build
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print(f"sass int8_wg_kernel: not measured (no {tool})", flush=True)
        return
    out = subprocess.run([str(tool), "-sass", str(_build.lib_path(
        _build.sources()))], capture_output=True, text=True).stdout
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name = part.split(None, 1)[0]
        m = re.search(r"int8_wg_kernelI((?:Li\d+E)+)E", name)
        if m is None:
            continue
        args = ", ".join(re.findall(r"Li(\d+)E", m.group(1)))
        i2f = re.findall(r"\b(I2FP?(?:\.[A-Z0-9]+)*)\b", part)
        ex2 = len(re.findall(r"\bMUFU\.EX2\b", part))
        print(f"sass int8_wg_kernel<{args}>: {len(i2f)} I2F "
              f"({', '.join(sorted(set(i2f))) or '-'}), {ex2} MUFU.EX2, "
              f"{len(i2f) / max(ex2, 1):.3f} conversions a logit",
              flush=True)


def study_f_baselines(dev, card: str) -> dict:
    """Kernel F's time at each study shape, on the studies' inputs in F's
    (B, S, H*D) layout: the product forward that each study case reads
    against. {shape: (mean ms, device time alone ms or None)}."""
    import torch
    from storygen_tpu_torch.ops import flash_attention as fa
    from storygen_tpu_torch.studies import common
    f_ms = {}
    for shape, (b, h, sq, skv, d) in STUDY_SHAPES.items():
        q, k, v = (fa.merge_heads(t) for t in common.qkv(
            dev, b, h, sq, skv, d, seed=4))
        with torch.no_grad():
            call = lambda: fa.flash_fwd(q, k, v, h, d ** -0.5)  # noqa: E731
            f_ms[shape] = (cuda_ms(call, 10),
                           device_ms(call, "flash_wg_kernel"))
        alone = f_ms[shape][1]
        print(f"study F baseline {shape} B{b} {sq}x{skv} d{d}: kernel F "
              f"{f_ms[shape][0]:.4f} ms (device time alone "
              f"{'not measured' if alone is None else f'{alone:.4f} ms'})"
              f"  [{card}]", flush=True)
        del q, k, v
    return f_ms


# the ablation split: at each shape, the ablate_attention cases (do_exp,
# do_pv) whose device time alone is printed as a share of F's alone
ABLATION_SPLIT = {"QK": (False, False), "QK_EXP": (True, False),
                  "QK_PV": (False, True), "TB": (True, True)}


def ablation_split(splits: dict, f_ms: dict, card: str) -> None:
    """One line a shape: QK (the products), QK_EXP (the products and the
    exps), QK_PV (both products, no exps) and TB (all of it) alone, each
    as a share of F alone at the same shape ("not measured" where a
    trace lost the kernel)."""
    for shape, alone in splits.items():
        f_alone = f_ms[shape][1]
        parts = []
        for name, key in ABLATION_SPLIT.items():
            t = alone.get(key)
            if t is None or f_alone is None:
                parts.append(f"{name} not measured")
            else:
                parts.append(f"{name} {t:.4f} ms ({t / f_alone:.0%} of F)")
        f_txt = "not measured" if f_alone is None else f"{f_alone:.4f} ms"
        print(f"study ablation split {shape} bq=128 bk=128, alone: "
              f"{'  '.join(parts)}  F {f_txt}  [{card}]", flush=True)


def phase_studies(dev, card: str, results: dict) -> bool:
    """The study path's launches, the S1-S4 ptxas report, then every
    study case: kernel against its plain version on the same inputs, with
    times beside SDPA's and kernel F's at the case's shape."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    reset_launches()
    study_path()
    torch.cuda.synchronize()
    ok = record_launches(results, read_launches(), "studies")
    ok &= study_ptxas()
    int8_sass()
    torch.cuda.empty_cache()
    f_ms = study_f_baselines(dev, card)
    library_ms = {}
    splits = {}  # shape: {(do_exp, do_pv): device time alone}
    for c, rtol in study_cases(dev):
        with torch.no_grad():
            out = c.kern().float()
            ref = c.plain().float()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        bound = rtol * ref.abs().max().item()
        good = (out.shape == ref.shape and err <= bound
                and bool(torch.isfinite(out).all().item()))
        ok &= good
        del out, ref
        with torch.no_grad():
            ms = cuda_ms(c.kern, 10)
            alone = device_ms(c.kern,
                              STUDY_ENTRIES[KERNEL_META[c.name]["source"]])
            plain_ms = cuda_ms(c.plain, 3)
            lib_ms = None
            if c.library is not None:
                key = (c.label.split(" ")[0], c.label.split(" ")[1])
                if key not in library_ms:
                    library_ms[key] = cuda_ms(c.library, 5)
                lib_ms = library_ms[key]
            yard_ms = (None if c.yardstick is None
                       else cuda_ms(c.yardstick, 5))
        b_ms, b_term = bound_ms(c.flops, c.nbytes, c.exps)
        b_by = "bytes" if b_term == "bytes" else "operations"
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
        if yard_ms is not None:
            lib += f" (yardstick: bf16 torch.bmm q k^T {yard_ms:.4f} ms)"
        shape = " ".join(c.label.split(" ")[:2])
        shape_f, f_alone = f_ms[shape]
        own = "not measured" if alone is None else f"{alone:.4f} ms"
        vs_f = ("" if alone is None or f_alone is None
                else f", alone {alone / f_alone:.2f}x F alone")
        if c.name == "ablate_attention" and "bq=128 bk=128" in c.label:
            key = ("do_exp=True" in c.label, "do_pv=True" in c.label)
            splits.setdefault(shape, {})[key] = alone
        print(f"study {c.name:23s} {c.label:58s} max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'};  kernel "
              f"{ms:.4f} ms (device time alone {own})  plain "
              f"{plain_ms:.4f} ms  library {lib}  bound {b_ms:.4f} ms "
              f"({b_term})  F {shape_f:.4f} ms (alone "
              f"{'not measured' if f_alone is None else f'{f_alone:.4f} ms'}"
              f"{vs_f})  [{card}]", flush=True)
        r = results.setdefault(c.name, {"name": c.name, **KERNEL_META[c.name]})
        for key, val in (("max_abs_err", 0.0), ("ms", 0.0), ("plain_ms", 0.0),
                         ("bound_ms", 0.0), ("library_ms", None),
                         ("cases", [])):
            r.setdefault(key, val)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["cases"].append({"case": c.label, "max_abs_err": err,
                           "bound": bound, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "bound_term": b_term, "library_ms": lib_ms,
                           "device_ms": alone, "f_ms": shape_f,
                           "f_alone_ms": f_alone, "yardstick_ms": yard_ms})
        r["bound_by"] = max(r["cases"], key=lambda x: x["bound_ms"])[
            "bound_by"]
    ablation_split(splits, f_ms, card)
    # the summed cases have a library time only if each case has one (the
    # ablated modes compute no attention)
    for name in STUDY_KERNELS:
        r = results[name]
        if any(x["library_ms"] is None for x in r["cases"]):
            r["library_ms"] = None
    torch.cuda.empty_cache()
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
    for name, phase in (
            ("kernels", lambda: phase_kernels(dev, card, results)),
            ("models", lambda: phase_models(dev, card)),
            ("story", lambda: phase_story(dev, card, results)),
            ("train", lambda: phase_train(dev, card, results)),
            ("story_fused", lambda: phase_story(dev, card, results, "fused")),
            ("serving", lambda: phase_serving(dev, card, results)),
            ("train_fused", lambda: phase_train(dev, card, results, "fused")),
            ("checkpoint", lambda: phase_checkpoint(dev, card, results)),
            ("train_more", lambda: phase_train_more(dev, card, results)),
            ("cli", lambda: phase_cli(dev, card, results)),
            ("dataset", lambda: phase_dataset(dev, card, results)),
            ("quality", lambda: phase_quality(dev, card, results)),
            # before `parallel`: after its NCCL group and spawned ranks the
            # profiler lost most of the studies' kernels
            ("studies", lambda: phase_studies(dev, card, results)),
            ("parallel", lambda: phase_parallel(dev, card, results))):
        t0 = time.perf_counter()
        if not phase():
            failed.append(name)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [results[k] for k in KERNEL_META]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
