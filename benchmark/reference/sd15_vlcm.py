"""Plain PyTorch reference of the SD-1.5 + VLCM models, the DDIM frame and
the stage-2 training loss, in float32.

Written from the published math (diffusers 0.13's UNet2DConditionModel,
AutoencoderKL and transformers' CLIPTextModel, with StoryGen's VLCM fork:
model/attention.py's attn1 tap and attn2 || attn3 sum, model/pipeline.py's
per-step reference cycle, kv concat over the references and 3-way CFG,
train_StorySalon_stage2.py's masked MSE), functional over a state dict
keyed by the diffusers names (OIHW conv weights, (out, in) linears), NCHW
inside. It imports nothing of the program under test: the benchmark hands
it the weights and inputs it made and the configuration file's sizes.

Every product goes through a `Numerics` (numerics.py): float32, or the
float8 control. Attention is computed in query blocks without a graph, so
a 4096 x 12288 attn3 fits.

Departures from the published description: none in the math. The
reference pass runs the rows [zero | uncond] and [ref | cond] once per
reference; model/pipeline.py's third row repeats the second exactly.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics

Tensors = Dict[str, torch.Tensor]
Q_BLOCK = 1024  # query rows per attention block without a graph


# ------------------------------------------------------------ primitives
def linear(nm: Numerics, x, sd: Tensors, p: str, bias: bool = True):
    b = sd.get(p + ".bias") if bias else None
    return F.linear(nm.q(x), nm.q(sd[p + ".weight"]), b)


def conv(nm: Numerics, x, sd: Tensors, p: str, stride: int = 1,
         padding: int = 1):
    return F.conv2d(nm.q(x), nm.q(sd[p + ".weight"]), sd[p + ".bias"],
                    stride, padding)


def group_norm(x, sd: Tensors, p: str, groups: int, eps: float):
    return F.group_norm(x, groups, sd[p + ".weight"], sd[p + ".bias"], eps)


def layer_norm(x, sd: Tensors, p: str, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"],
                        eps)


def attention_core(nm: Numerics, q, k, v, heads: int,
                   bias: Optional[torch.Tensor] = None):
    """softmax(q k^T / sqrt(d) + bias) v over (R, S, H*D) tensors; `bias`
    (R, 1, 1, Skv) additive. Query blocks when no graph is built."""
    r, sq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(r, -1, heads, d).transpose(1, 2)

    qh, kh, vh = split(nm.q(q)), split(nm.q(k)), split(nm.q(v))
    kt = kh.transpose(-1, -2)
    step = sq if torch.is_grad_enabled() else Q_BLOCK
    outs = []
    for s in range(0, sq, step):
        logits = qh[:, :, s:s + step] @ kt * d ** -0.5
        if bias is not None:
            logits = logits + bias
        probs = torch.softmax(logits, dim=-1)
        outs.append(nm.q(probs) @ vh)
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return out.transpose(1, 2).reshape(r, sq, inner)


def cross_attention(nm, x, context, sd, p, heads, bias=None):
    """diffusers CrossAttention: to_q/k/v without bias, to_out.0 with."""
    q = linear(nm, x, sd, p + ".to_q", bias=False)
    k = linear(nm, context, sd, p + ".to_k", bias=False)
    v = linear(nm, context, sd, p + ".to_v", bias=False)
    return linear(nm, attention_core(nm, q, k, v, heads, bias), sd,
                  p + ".to_out.0")


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, freq_shift=0): [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def ref_mask_bias(keep: torch.Tensor, span: int) -> torch.Tensor:
    """(R, N) keep flags over N kv spans of `span` rows -> (R, 1, 1, N*span)
    additive bias, -inf on the dropped spans."""
    drop = ~keep.bool().repeat_interleave(span, dim=1)
    bias = torch.zeros(drop.shape, device=keep.device)
    return bias.masked_fill(drop, float("-inf"))[:, None, None, :]


# ------------------------------------------------------------ UNet
def resnet(nm, x, temb, sd, p, groups, eps):
    h = F.silu(group_norm(x, sd, p + ".norm1", groups, eps))
    h = conv(nm, h, sd, p + ".conv1")
    if temb is not None:
        h = h + linear(nm, F.silu(temb), sd, p + ".time_emb_proj")[
            :, :, None, None]
    h = conv(nm, F.silu(group_norm(h, sd, p + ".norm2", groups, eps)), sd,
             p + ".conv2")
    if p + ".conv_shortcut.weight" in sd:
        x = conv(nm, x, sd, p + ".conv_shortcut", padding=0)
    return x + h


def transformer(nm, x, sd, p, text, heads, groups, image=None,
                image_bias=None):
    """GN (eps 1e-6) -> 1x1 proj_in -> BasicTransformerBlock -> 1x1
    proj_out -> + x. Returns (out, the post-attn1 tap (R, S, C))."""
    r, c, hh, ww = x.shape
    h = conv(nm, group_norm(x, sd, p + ".norm", groups, 1e-6), sd,
             p + ".proj_in", padding=0)
    inner = h.shape[1]
    h = h.permute(0, 2, 3, 1).reshape(r, hh * ww, inner)
    b = p + ".transformer_blocks.0"
    n1 = layer_norm(h, sd, b + ".norm1")
    h = cross_attention(nm, n1, n1, sd, b + ".attn1", heads) + h
    tap = h
    h_t = cross_attention(nm, layer_norm(h, sd, b + ".norm2"), text, sd,
                          b + ".attn2", heads) + h
    if image is not None:
        h = h_t + (cross_attention(nm, layer_norm(h, sd, b + ".norm4"),
                                   image, sd, b + ".attn3", heads,
                                   image_bias) + h)
    else:
        h = h_t
    proj = linear(nm, layer_norm(h, sd, b + ".norm3"), sd,
                  b + ".ff.net.0.proj")
    value, gate = proj.chunk(2, dim=-1)
    h = linear(nm, value * F.gelu(gate), sd, b + ".ff.net.2") + h
    h = h.reshape(r, hh, ww, inner).permute(0, 3, 1, 2)
    return conv(nm, h, sd, p + ".proj_out", padding=0) + x, tap


def unet(nm: Numerics, sd: Tensors, cfg: dict, sample: torch.Tensor,
         t: torch.Tensor, text: torch.Tensor,
         context: Optional[Tensors] = None,
         ref_mask: Optional[torch.Tensor] = None):
    """UNet2DConditionModel + VLCM. sample (R, h, w, 4) NHWC, t (R,), text
    (R, 77, D); context None (the reference cycle: collect the taps) or
    {key: (R, N*S, C)} (attn3 over the references), ref_mask (R, N) keep
    flags. Returns (eps (R, h, w, 4), taps {key: (R, S, C)}).
    Keys: down_{i+1}_{j+1}, mid, up_{i}_{j+1} by block and layer."""
    heads, g, eps = (cfg["attention_head_dim"], cfg["norm_num_groups"],
                     cfg["norm_eps"])
    ch = cfg["block_out_channels"]
    n_lay = cfg["layers_per_block"]
    emb = timestep_embedding(t, ch[0])
    emb = linear(nm, emb, sd, "time_embedding.linear_1")
    emb = linear(nm, F.silu(emb), sd, "time_embedding.linear_2")
    h = conv(nm, sample.permute(0, 3, 1, 2), sd, "conv_in")
    taps: Tensors = {}
    states = [h]

    def attn(h, p, key):
        img = bias = None
        if context is not None:
            img = context[key]
            if ref_mask is not None:
                bias = ref_mask_bias(ref_mask, img.shape[1]
                                     // ref_mask.shape[1])
        h, tap = transformer(nm, h, sd, p, text, heads, g, img, bias)
        if context is None:
            taps[key] = tap
        return h

    for i, kind in enumerate(cfg["down_block_types"]):
        p = f"down_blocks.{i}"
        for j in range(n_lay):
            h = resnet(nm, h, emb, sd, f"{p}.resnets.{j}", g, eps)
            if kind == "CrossAttnDownBlock2D":
                h = attn(h, f"{p}.attentions.{j}", f"down_{i + 1}_{j + 1}")
            states.append(h)
        if i < len(ch) - 1:
            h = conv(nm, h, sd, f"{p}.downsamplers.0.conv", stride=2)
            states.append(h)
    h = resnet(nm, h, emb, sd, "mid_block.resnets.0", g, eps)
    h = attn(h, "mid_block.attentions.0", "mid")
    h = resnet(nm, h, emb, sd, "mid_block.resnets.1", g, eps)
    for i, kind in enumerate(cfg["up_block_types"]):
        p = f"up_blocks.{i}"
        for j in range(n_lay + 1):
            h = torch.cat([h, states.pop()], dim=1)
            h = resnet(nm, h, emb, sd, f"{p}.resnets.{j}", g, eps)
            if kind == "CrossAttnUpBlock2D":
                h = attn(h, f"{p}.attentions.{j}", f"up_{i}_{j + 1}")
        if i < len(ch) - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(nm, h, sd, f"{p}.upsamplers.0.conv")
    h = F.silu(group_norm(h, sd, "conv_norm_out", g, eps))
    h = conv(nm, h, sd, "conv_out")
    return h.permute(0, 2, 3, 1), taps


# ------------------------------------------------------------ VAE
def vae_attention(nm, x, sd, p, groups):
    """Single-head spatial self-attention (diffusers 0.13 AttentionBlock)."""
    r, c, hh, ww = x.shape
    y = group_norm(x, sd, p + ".group_norm", groups, 1e-6)
    y = y.reshape(r, c, hh * ww).transpose(1, 2)
    q = linear(nm, y, sd, p + ".query")
    k = linear(nm, y, sd, p + ".key")
    v = linear(nm, y, sd, p + ".value")
    y = linear(nm, attention_core(nm, q, k, v, 1), sd, p + ".proj_attn")
    return y.transpose(1, 2).reshape(r, c, hh, ww) + x


def vae_encode(nm: Numerics, sd: Tensors, cfg: dict, x: torch.Tensor):
    """(R, H, W, 3) -> (mean, logvar clamped to [-30, 20]), each (R, h, w,
    4). The downsampler pads (0, 1, 0, 1) and convolves VALID."""
    g, ch = cfg["norm_num_groups"], cfg["block_out_channels"]
    h = conv(nm, x.permute(0, 3, 1, 2), sd, "encoder.conv_in")
    for i in range(len(ch)):
        p = f"encoder.down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            h = resnet(nm, h, None, sd, f"{p}.resnets.{j}", g, 1e-6)
        if i < len(ch) - 1:
            h = conv(nm, F.pad(h, (0, 1, 0, 1)), sd,
                     f"{p}.downsamplers.0.conv", stride=2, padding=0)
    h = resnet(nm, h, None, sd, "encoder.mid_block.resnets.0", g, 1e-6)
    h = vae_attention(nm, h, sd, "encoder.mid_block.attentions.0", g)
    h = resnet(nm, h, None, sd, "encoder.mid_block.resnets.1", g, 1e-6)
    h = F.silu(group_norm(h, sd, "encoder.conv_norm_out", g, 1e-6))
    h = conv(nm, h, sd, "encoder.conv_out")
    moments = conv(nm, h, sd, "quant_conv", padding=0).permute(0, 2, 3, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def vae_decode(nm: Numerics, sd: Tensors, cfg: dict, z: torch.Tensor):
    """(R, h, w, 4) unscaled latents -> (R, H, W, 3), before the [0, 1]
    map."""
    g, ch = cfg["norm_num_groups"], cfg["block_out_channels"]
    h = conv(nm, z.permute(0, 3, 1, 2), sd, "post_quant_conv", padding=0)
    h = conv(nm, h, sd, "decoder.conv_in")
    h = resnet(nm, h, None, sd, "decoder.mid_block.resnets.0", g, 1e-6)
    h = vae_attention(nm, h, sd, "decoder.mid_block.attentions.0", g)
    h = resnet(nm, h, None, sd, "decoder.mid_block.resnets.1", g, 1e-6)
    for i in range(len(ch)):
        p = f"decoder.up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            h = resnet(nm, h, None, sd, f"{p}.resnets.{j}", g, 1e-6)
        if i < len(ch) - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv(nm, h, sd, f"{p}.upsamplers.0.conv")
    h = F.silu(group_norm(h, sd, "decoder.conv_norm_out", g, 1e-6))
    return conv(nm, h, sd, "decoder.conv_out").permute(0, 2, 3, 1)


def encode_sample(nm, sd, cfg, x, noise, rows: int = 4):
    """Posterior draws (mean + std * noise) * scaling_factor, in blocks of
    `rows` images."""
    out = []
    for s in range(0, x.shape[0], rows):
        mean, logvar = vae_encode(nm, sd, cfg, x[s:s + rows])
        out.append(mean + torch.exp(0.5 * logvar) * noise[s:s + rows])
    return torch.cat(out) * cfg["scaling_factor"]


def decode_image(nm, sd, cfg, latents):
    """Final latents -> images in [0, 1] (the pipeline's map)."""
    img = vae_decode(nm, sd, cfg, latents / cfg["scaling_factor"])
    return (img / 2 + 0.5).clamp(0.0, 1.0)


# ------------------------------------------------------------ CLIP text
def clip_text(nm: Numerics, sd: Tensors, cfg: dict, ids: torch.Tensor):
    """CLIPTextModel's last_hidden_state: (R, S) ids -> (R, S, D), causal
    pre-LN layers with quick_gelu."""
    p = "text_model."
    s = ids.shape[1]
    x = (sd[p + "embeddings.token_embedding.weight"][ids]
         + sd[p + "embeddings.position_embedding.weight"][:s][None])
    causal = torch.full((s, s), float("-inf"), device=ids.device).triu(1)
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{p}encoder.layers.{i}."
        y = layer_norm(x, sd, lp + "layer_norm1", eps)
        q = linear(nm, y, sd, lp + "self_attn.q_proj")
        k = linear(nm, y, sd, lp + "self_attn.k_proj")
        v = linear(nm, y, sd, lp + "self_attn.v_proj")
        a = attention_core(nm, q, k, v, heads, causal[None, None])
        x = x + linear(nm, a, sd, lp + "self_attn.out_proj")
        y = linear(nm, layer_norm(x, sd, lp + "layer_norm2", eps), sd,
                   lp + "mlp.fc1")
        x = x + linear(nm, y * torch.sigmoid(1.702 * y), sd, lp + "mlp.fc2")
    return layer_norm(x, sd, p + "final_layer_norm", eps)


# ------------------------------------------------------------ schedule
class DDIM:
    """scaled_linear betas, leading timesteps + steps_offset,
    set_alpha_to_one false (SD-1.5's scheduler_config.json), eta 0."""

    def __init__(self, cfg: dict):
        n = cfg["num_train_timesteps"]
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                            n, dtype=np.float64) ** 2
        self.acp = np.cumprod(1.0 - betas)
        self.final = 1.0 if cfg["set_alpha_to_one"] else self.acp[0]
        self.n, self.offset = n, cfg["steps_offset"]

    def timesteps(self, steps: int) -> np.ndarray:
        ratio = self.n // steps
        return (np.arange(steps) * ratio).round()[::-1].astype(
            np.int64) + self.offset

    def add_noise(self, x, noise, t):
        """t: int or (R,) ints."""
        acp = torch.as_tensor(self.acp, dtype=torch.float32,
                              device=x.device)[torch.as_tensor(
                                  t, device=x.device).long()]
        acp = acp.reshape(acp.shape + (1,) * (x.dim() - acp.dim()))
        return acp.sqrt() * x + (1.0 - acp).sqrt() * noise

    def step(self, eps, t: int, prev_t: int, x):
        a_t = self.acp[t]
        a_prev = self.acp[prev_t] if prev_t >= 0 else self.final
        x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
        return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


# ------------------------------------------------------------ frame
def frame(nm: Numerics, sd: Tensors, cfg: dict, inputs: Tensors) -> Tensors:
    """One story frame for R stories, as model/pipeline.py computes it at
    eta 0.

    inputs: ids_uncond (77,), ids_cond (R, 77), latents and noise (R, h,
    w, 4); with references also ref_images (N, R, H, W, 3) in [0, 1],
    oldest first, ref_ids (N, R, 77), ref_posterior (N, R, h, w, 4),
    zero_posterior (R, h, w, 4). cfg: the configuration file (unet, vae,
    text_encoder, scheduler, sampling). Returns {"latents" (R, h, w, 4),
    "image" (R, H, W, 3)}."""
    u, v, c = cfg["unet"], cfg["vae"], cfg["text_encoder"]
    smp = cfg["sampling"]
    sched = DDIM(cfg["scheduler"])
    ts = sched.timesteps(smp["num_inference_steps"])
    ratio = sched.n // smp["num_inference_steps"]
    prevs = list(ts[1:]) + [int(ts[-1]) - ratio]
    gs, igs = smp["guidance_scale"], smp["image_guidance_scale"]
    refs = "ref_images" in inputs
    x = inputs["latents"].float()
    r = x.shape[0]
    dev = x.device
    noise = inputs["noise"]
    text_u = clip_text(nm, sd, c, inputs["ids_uncond"][None]).expand(
        r, -1, -1)
    text_c = clip_text(nm, sd, c, inputs["ids_cond"])
    if refs:
        n = inputs["ref_images"].shape[0]
        imgs = inputs["ref_images"]
        ref_lat = encode_sample(nm, sd, v, imgs.reshape((n * r,)
                                                        + imgs.shape[2:]),
                                inputs["ref_posterior"].reshape(
                                    (n * r,) + x.shape[1:]))
        ref_lat = ref_lat.reshape((n, r) + x.shape[1:])
        zero_lat = encode_sample(nm, sd, v, torch.zeros_like(imgs[0]),
                                 inputs["zero_posterior"])
        prev_c = clip_text(nm, sd, c, inputs["ref_ids"].reshape(n * r, -1))
        prev_c = prev_c.reshape((n, r) + prev_c.shape[1:])
        text3 = torch.cat([text_u, text_u, text_c])
        # per reference: R rows [zero | uncond], then R rows [ref | cond]
        pair_text = torch.cat([torch.cat([text_u, prev_c[i]])
                               for i in range(n)])
    else:
        text2 = torch.cat([text_u, text_c])
    for t, prev_t in zip(ts, prevs):
        t = int(t)
        if refs:
            levels = [(t // 10) * (n - i) for i in range(n)]
            rows = torch.cat([torch.cat([sched.add_noise(zero_lat, noise, lv),
                                         sched.add_noise(ref_lat[i], noise,
                                                         lv)])
                              for i, lv in enumerate(levels)])
            lv_rows = torch.tensor([lv for lv in levels
                                    for _ in range(2 * r)], device=dev)
            _, taps = unet(nm, sd, u, rows, lv_rows, pair_text)
            ctx = {}
            for k, tap in taps.items():
                tap = tap.reshape((n, 2, r) + tap.shape[1:])
                zero_kv, ref_kv = (tap[:, j].transpose(0, 1).reshape(
                    r, n * tap.shape[3], tap.shape[4]) for j in (0, 1))
                ctx[k] = torch.cat([zero_kv, ref_kv, ref_kv])
            eps3, _ = unet(nm, sd, u, torch.cat([x, x, x]),
                           torch.full((3 * r,), t, device=dev), text3, ctx)
            e_u, e_i, e_a = eps3.chunk(3)
            eps = e_u + igs * (e_i - e_u) + gs * (e_a - e_i)
        else:
            eps2, _ = unet(nm, sd, u, torch.cat([x, x]),
                           torch.full((2 * r,), t, device=dev), text2)
            e_u, e_c = eps2.chunk(2)
            eps = e_u + gs * (e_c - e_u)
        x = sched.step(eps, t, int(prev_t), x)
    return {"latents": x, "image": decode_image(nm, sd, v, x)}


# ------------------------------------------------------------ training
def downsample_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """(R, H, W, 1) -> (R, H/f, W/f, 1): bilinear, half-pixel centres, no
    antialiasing (the reference's F.interpolate(scale_factor=1/8))."""
    x = mask.float().permute(0, 3, 1, 2)
    h, w = x.shape[2] // factor, x.shape[3] // factor
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def stage2_grads(nm: Numerics, frozen: Tensors, trained: Tensors,
                 cfg: dict, batch: Tensors, draws: Tensors,
                 rows: int = 1) -> torch.Tensor:
    """One stage-2 micro-step's masked noise-prediction MSE over the batch
    (train_StorySalon_stage2.py), accumulated into `.grad` of the
    `trained` leaves (fp32, requires_grad), in blocks of `rows` samples.
    Returns the loss.

    batch: image (B, H, W, 3), mask (B, H, W, 1), input_ids (B, 77),
    ref_images (N, B, H, W, 3), ref_input_ids (N, B, 77). draws:
    posterior_noise, noise, ref_noise (B, h, w, 4), t (B,),
    ref_posterior_noise (N*B, h, w, 4) ref-major, ref_mask (B, N) keep."""
    u, v, c = cfg["unet"], cfg["vae"], cfg["text_encoder"]
    sched = DDIM(cfg["scheduler"])
    sd = {**frozen, **trained}
    b = batch["image"].shape[0]
    n = batch["ref_images"].shape[0]
    down = 2 ** (len(v["block_out_channels"]) - 1)
    t = draws["t"].long()
    with torch.no_grad():
        lat = encode_sample(nm, sd, v, batch["image"],
                            draws["posterior_noise"])
        refs = batch["ref_images"].reshape((n * b,)
                                           + batch["ref_images"].shape[2:])
        ref_lat = encode_sample(nm, sd, v, refs, draws["ref_posterior_noise"])
        ref_lat = ref_lat.reshape((n, b) + ref_lat.shape[1:])
        text = torch.cat([clip_text(nm, sd, c, batch["input_ids"][s:s + 4])
                          for s in range(0, b, 4)])
        ids = batch["ref_input_ids"].reshape(n * b, -1)
        prev = torch.cat([clip_text(nm, sd, c, ids[s:s + 4])
                          for s in range(0, n * b, 4)])
        prev = prev.reshape((n, b) + prev.shape[1:])
        noisy = sched.add_noise(lat, draws["noise"], t)
        ref_ts = (t // 10)[None, :] * torch.arange(n, 0, -1,
                                                   device=t.device)[:, None]
        noisy_refs = sched.add_noise(ref_lat, draws["ref_noise"][None], ref_ts)
        keep = 1.0 - downsample_mask(batch["mask"], down)
    total = torch.zeros((), device=t.device)
    count = noisy.numel()
    for s in range(0, b, rows):
        sl = slice(s, s + rows)
        with torch.no_grad():
            r = noisy_refs[:, sl]
            rr = r.shape[1]
            _, taps = unet(nm, sd, u, r.reshape((n * rr,) + r.shape[2:]),
                           ref_ts[:, sl].reshape(-1),
                           prev[:, sl].reshape((n * rr,) + prev.shape[2:]))
            ctx = {k: x.reshape((n, rr) + x.shape[1:]).transpose(0, 1)
                   .reshape(rr, n * x.shape[1], x.shape[2])
                   for k, x in taps.items()}
        pred, _ = unet(nm, sd, u, noisy[sl], t[sl], text[sl], ctx,
                       draws["ref_mask"][sl])
        part = ((pred * keep[sl] - draws["noise"][sl] * keep[sl]) ** 2
                ).sum() / count
        part.backward()
        total = total + part.detach()
    return total


def adamw_first_update(p: torch.Tensor, grad: torch.Tensor, cfg: dict
                       ) -> torch.Tensor:
    """The parameter change of AdamW's first update (count 1, bias
    corrected, eps outside the root, decoupled weight decay) from the
    clipped gradient `grad`, at the schedule's first rate."""
    tr = cfg["training"]
    b1, b2 = tr["adam_beta1"], tr["adam_beta2"]
    mu, nu = (1 - b1) * grad, (1 - b2) * grad * grad
    upd = (mu / (1 - b1)) / (torch.sqrt(nu / (1 - b2)) + tr["adam_epsilon"])
    return -tr["learning_rate"] * (upd + tr["adam_weight_decay"] * p)


def per_leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def counted_leaves(reference: Dict[str, float],
                   floor_share: float = 1e-3) -> List[str]:
    """The leaves whose reference norm is at least `floor_share` of the
    median leaf's: the others are nought to rounding."""
    med = float(np.median(list(reference.values())))
    return [k for k, r in reference.items() if r >= floor_share * med]


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             counted: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over max(the reference leaf's norm, the median leaf's),
    over the `counted` leaves (by default those of `counted_leaves`)."""
    med = float(np.median(list(reference.values())))
    keys = counted_leaves(reference) if counted is None else counted
    gaps = [abs(program[k] - reference[k]) / max(reference[k], med)
            for k in keys]
    return max(gaps) if gaps else float("nan")


def diff_gap(program: Tensors, reference: Tensors,
             counted: List[str]) -> float:
    """The worst counted leaf's ||program - reference|| over max(the
    reference leaf's norm, the median leaf's): blind to neither the
    direction nor the scale."""
    norms = per_leaf_norms(reference)
    med = float(np.median(list(norms.values())))
    gaps = [float((program[k].float() - reference[k].float()).norm())
            / max(norms[k], med) for k in counted]
    return max(gaps) if gaps else float("nan")


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """The gradients scaled by max_norm / their global norm where that
    norm reaches max_norm, else as they are."""
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))
    if norm < max_norm:
        return dict(grads)
    return {k: g * (max_norm / norm) for k, g in grads.items()}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))
