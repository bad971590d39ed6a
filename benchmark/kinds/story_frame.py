"""Traffic kind `story_frame`: concurrent stories' next frames, one frame
call at a time.

A call serves `batch` stories at once, each on its `refs` previous frames
(0: the first frame, stage "no"): a CLIP pass over the empty caption,
each story's new caption and its references' captions; the references'
VAE encode (`StoryGenSampler.encode_ref_latents`) from the decoded
pixels; `StoryGenSampler.sample` (DDIM, the batched reference pass,
3-way CFG); `decode`. The decoded frames become the stories' newest
references and their captions the newest reference captions, so the
stories roll on and no two calls repeat. Every draw of call k comes from
a generator on the card seeded from (seed, k): latents, the references'
and the zero image's posterior noise, the reference noise, the captions'
lengths and tokens; the first references are drawn from (seed, the
history).

The check recomputes, after the window, call k's frames of two stories
(one from each half of the batch; k and the stories drawn from the seed)
with the float32 reference on the same inputs, and compares the final
latents and the decoded images.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import counts, program
from benchmark.weights import spec_of, sub_seed

HISTORY, CALLS, CHECK, WARM_UP = 7, 11, 13, 17  # the seeds' paths


def caption_ids(g: torch.Generator, rows: int, cfg: dict, lengths,
                device) -> torch.Tensor:
    """(rows, L) ids: BOS, n tokens below BOS, EOS, EOS padding; n drawn
    in [lengths[0], lengths[1]]."""
    tok = cfg["tokenizer"]
    size = cfg["text_encoder"]["max_position_embeddings"]
    n = torch.randint(lengths[0], lengths[1] + 1, (rows, 1), generator=g,
                      device=device)
    words = torch.randint(0, tok["bos_id"], (rows, size), generator=g,
                          device=device)
    pos = torch.arange(size, device=device)[None]
    ids = torch.where(pos <= n, words, torch.full_like(words, tok["pad_id"]))
    ids = torch.where(pos == n + 1, torch.full_like(ids, tok["eos_id"]), ids)
    ids[:, 0] = tok["bos_id"]
    return ids


def empty_ids(cfg: dict, device) -> torch.Tensor:
    tok = cfg["tokenizer"]
    size = cfg["text_encoder"]["max_position_embeddings"]
    ids = torch.full((size,), tok["pad_id"], dtype=torch.long, device=device)
    ids[0], ids[1] = tok["bos_id"], tok["eos_id"]
    return ids


class StoryFrame:
    unit = "frames"
    job = "serve"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype=torch.bfloat16):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.dtype = device, dtype
        self.b, self.n = traffic["batch"], traffic["refs"]
        smp = cfg["sampling"]
        self.px = smp["height"]
        self.hw = self.px // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        self.steps = smp["num_inference_steps"]
        self.done: List[dict] = []  # per call of the window: its outputs
        self.vae_events: List[tuple] = []
        self.record_vae = False
        self.profile_at: Dict[int, list] = {}  # UNet pass -> actions

    # ------------------------------------------------------------ inputs
    def draws(self, k: int) -> Dict[str, torch.Tensor]:
        """Call k's draws, in a fixed order from one generator."""
        path = (CALLS, k) if k >= 0 else (WARM_UP,)
        g = torch.Generator(device=self.dev).manual_seed(
            sub_seed(self.seed, *path))
        b, n, hw = self.b, self.n, self.hw
        lat = (b, hw, hw, self.cfg["unet"]["in_channels"])
        out = {"latents": torch.randn(lat, generator=g, device=self.dev)}
        if n:
            out["ref_posterior"] = torch.randn((n * b,) + lat[1:],
                                               generator=g, device=self.dev)
            out["zero_posterior"] = torch.randn(lat, generator=g,
                                                device=self.dev)
        out["noise"] = torch.randn(lat, generator=g, device=self.dev)
        out["ids"] = caption_ids(g, b, self.cfg,
                                 self.traffic["caption_tokens"], self.dev)
        return out

    def first_history(self):
        """The stories' first references: pixels (N, B, H, W, 3) in [0, 1]
        and their captions (N, B, 77)."""
        g = torch.Generator(device=self.dev).manual_seed(
            sub_seed(self.seed, HISTORY))
        n, b = self.n, self.b
        pix = torch.rand((n, b, self.px, self.px, 3), generator=g,
                         device=self.dev)
        ids = caption_ids(g, n * b, self.cfg, self.traffic["caption_tokens"],
                          self.dev).reshape(n, b, -1)
        return pix, ids

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from storygen_tpu_torch.configs import SchedulerConfig
        from storygen_tpu_torch.pipeline import StoryGenSampler
        self.models = program.build(self.cfg, self.seed, self.dev,
                                    self.dtype)
        self.specs = {k: spec_of(m) for k, m in self.models.items()}
        s = self.cfg["scheduler"]
        sched = SchedulerConfig(**{k: s[k] for k in (
            "num_train_timesteps", "beta_start", "beta_end", "beta_schedule",
            "set_alpha_to_one", "steps_offset", "clip_sample",
            "prediction_type")})
        self.sampler = StoryGenSampler(self.models["unet"],
                                       self.models["vae"], sched,
                                       device=self.dev)
        self.empty = empty_ids(self.cfg, self.dev)
        if self.n:
            self.hist, self.hist_ids = self.first_history()
            self.first = (self.hist.clone(), self.hist_ids.clone())
            with torch.no_grad():
                self.zero = self.models["vae"].encode(torch.zeros(
                    (self.b, self.px, self.px, 3), device=self.dev))
        self.unet_calls = 0
        self.models["unet"].register_forward_pre_hook(self._unet_pre)

    def warm_up(self) -> None:
        """One frame call at 2 DDIM steps: every shape the window uses."""
        steps, self.steps = self.steps, 2
        saved = (self.hist, self.hist_ids) if self.n else None
        self.call(-1, keep=False)
        self.steps = steps
        if saved:
            self.hist, self.hist_ids = saved

    def _unet_pre(self, module, args):
        self.unet_calls += 1
        for act in self.profile_at.pop(self.unet_calls, ()):
            act()

    def _vae_mark(self):
        if self.record_vae:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return None

    @torch.no_grad()
    def call(self, k: int, keep: bool = True) -> int:
        """Call k; returns the frames it completed (0 when an image is not
        finite)."""
        d = self.draws(k)
        b, n = self.b, self.n
        te = self.models["text_encoder"]
        smp = self.cfg["sampling"]
        parts = [self.empty.expand(b, -1), d["ids"]]
        if n:
            parts.append(self.hist_ids.reshape(n * b, -1))
        emb = te(torch.cat(parts))
        text_u, text_c = emb[:b], emb[b:2 * b]
        refs = zero = prev_u = prev_c = None
        t0 = self._vae_mark()
        if n:
            prev_c = emb[2 * b:].reshape((n, b) + emb.shape[1:])
            prev_u = text_u[None].expand((n,) + text_u.shape)
            refs = self.sampler.encode_ref_latents(self.hist,
                                                   d["ref_posterior"])
            zero = self.zero.sample(d["zero_posterior"]) \
                * self.cfg["vae"]["scaling_factor"]
        t1 = self._vae_mark()
        lat = self.sampler.sample(
            d["latents"], text_u, text_c, refs, zero, prev_u, prev_c,
            d["noise"], smp["guidance_scale"], smp["image_guidance_scale"],
            stage="auto-regressive" if n else "no",
            num_inference_steps=self.steps)
        t2 = self._vae_mark()
        img = self.sampler.decode(lat)
        t3 = self._vae_mark()
        if t0 is not None:
            self.vae_events.append((t0, t1, t2, t3))
        if n:
            self.hist = torch.cat([self.hist[1:], img[None]])
            self.hist_ids = torch.cat([self.hist_ids[1:], d["ids"][None]])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        ok = bool(torch.isfinite(img).all())
        if keep:
            self.done.append({"latents": lat, "image": img, "k": k,
                              "ok": ok})
        return b if ok else 0

    def profile_call(self, prof) -> None:
        """Profile 4 whole denoise steps of the next call twice: steps
        20-23 (the device alone), then steps 24-27 (host and device). Each
        step is one UNet pass, or two with references (reference pass,
        main pass)."""
        per = 2 if self.n else 1
        first = self.unet_calls + 20 * per + 1
        span = 4 * per
        self.profile_at = {first: [prof.start],
                           first + span: [prof.stop, prof.start],
                           first + 2 * span: [prof.stop]}
        self.profiled_steps = 4

    def vae_ms(self) -> Optional[float]:
        """Milliseconds of the references' encode and the decode per
        frame, over the calls recorded."""
        if not self.vae_events:
            return None
        ms = sum(t0.elapsed_time(t1) + t2.elapsed_time(t3)
                 for t0, t1, t2, t3 in self.vae_events)
        return ms / (len(self.vae_events) * self.b)

    # ------------------------------------------------------------ counts
    def unit_ops(self) -> List[counts.Op]:
        return counts.frame_call_ops(self.cfg, self.b, self.n)

    def profiled_ops(self) -> List[counts.Op]:
        """The ops of the denoise steps profiled on the device alone."""
        ops: List[counts.Op] = []
        u = self.cfg["unet"]
        for _ in range(self.profiled_steps):
            if self.n:
                ops += counts.unet_ops(u, 2 * self.n * self.b, self.hw)
                ops += counts.unet_ops(u, 3 * self.b, self.hw,
                                       kept=[self.n] * 3 * self.b,
                                       n_refs=self.n)
            else:
                ops += counts.unet_ops(u, 2 * self.b, self.hw)
        return ops

    start_index = 0

    def window_flops(self, done: List[int]) -> float:
        """Model FLOPs of the calls `done`."""
        return counts.flops(self.unit_ops()) * len(done)

    # ------------------------------------------------------------ check
    def release(self) -> None:
        """Free the program's state; keep the outputs of the calls."""
        self.models = self.sampler = self.zero = None
        self.hist = self.hist_ids = None

    def history_at(self, k: int):
        """The references' pixels and captions that call k was given."""
        pix, ids = self.first
        imgs = [c["image"] for c in self.done if c["k"] < k]  # in order
        caps = [self.draws(j)["ids"] for j in range(k)]
        allp = torch.cat([pix] + [i[None] for i in imgs])
        alli = torch.cat([ids] + [c[None] for c in caps])
        return allp[-self.n:], alli[-self.n:]

    def check_plan(self):
        """(k, rows): a completed call and one story from each half of
        the batch, drawn from the seed."""
        rng = np.random.default_rng(sub_seed(self.seed, CHECK))
        ok = [c["k"] for c in self.done if c["ok"]]
        k = ok[int(rng.integers(len(ok)))]
        half = self.b // 2
        rows = [int(rng.integers(half)), half + int(rng.integers(
            self.b - half))]
        return k, rows

    def reference_inputs(self, k: int, rows) -> Dict[str, torch.Tensor]:
        """Call k's inputs of the stories `rows`, as the program had them."""
        d = self.draws(k)
        inp = {"ids_uncond": self.empty, "ids_cond": d["ids"][rows],
               "latents": d["latents"][rows], "noise": d["noise"][rows]}
        if self.n:
            pix, ids = self.history_at(k)
            inp["ref_images"] = pix[:, rows]
            inp["ref_ids"] = ids[:, rows]
            inp["ref_posterior"] = d["ref_posterior"].reshape(
                (self.n, self.b) + d["ref_posterior"].shape[1:])[:, rows]
            inp["zero_posterior"] = d["zero_posterior"][rows]
        return inp

    def reference(self, numerics, k: int, rows) -> Dict[str, torch.Tensor]:
        from benchmark.reference import sd15_vlcm as R
        from benchmark.reference.numerics import fp32_products
        sd = program.reference_weights(self.specs, self.seed, self.dev,
                                       self.dtype)
        flat = {k: v for part in sd.values() for k, v in part.items()}
        del sd
        with fp32_products():
            return R.frame(numerics, flat, self.cfg,
                           self.reference_inputs(k, rows))

    @staticmethod
    def gaps(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
        from benchmark.reference import sd15_vlcm as R
        return {name: max(R.rel_l2(a, b) for a, b in zip(out[key],
                                                          ref[key]))
                for name, key in (("latent_rel", "latents"),
                                  ("image_rel", "image"))}

    def check(self, numerics) -> Dict[str, float]:
        """latent_rel, image_rel: the worst checked story's ||program -
        reference|| / ||reference|| of the final latents and the image."""
        k, rows = self.check_plan()
        out = next(c for c in self.done if c["k"] == k)
        return self.gaps({key: out[key][rows] for key in ("latents",
                                                          "image")},
                         self.reference(numerics, k, rows))

    def readings(self, low) -> Dict[str, Dict[str, float]]:
        """The limits' upper reading: the reference in `low` precision put
        in the program's place, against the float32 reference."""
        from benchmark.reference.numerics import Numerics
        k, rows = self.check_plan()
        return {"control": self.gaps(self.reference(low, k, rows),
                                     self.reference(Numerics("fp32"), k,
                                                    rows))}

KIND = StoryFrame
