"""Traffic kind `train_step`: the stage-2 job's micro-steps, one after
another.

Set-up builds one training step (`trainer.make_stage_step("stage2",
...)`: attn3 cast to fp32 and trained, AdamW with clipping and k-step
accumulation, the frozen VAE, CLIP and UNet in bf16, block checkpointing
as configured) and drives it from the seed through its first micro-steps
up to and including the first optimizer update; the window continues
with the same object. Micro-step m's batch and draws come from a
generator on the card seeded from (seed, m): 512 px targets and
references in [-1, 1], inpainting masks, captions, the datasets' CFG
dropout (empty prompts; zeroed references with empty captions), and the
step's draws (posterior and reference noise, t, each sample's kept
references); every row differs. The step is given the draws
(`draws=`), so the reference can take the same.

The check, after the window: the float32 reference follows micro-steps
1-k (through the first optimizer update, k the accumulation) from the
same initial weights, with its own mean of the k gradients, global-norm
clipping and AdamW, and compares each step's loss, the first gradient
(the optimizer's accumulator after micro-step 1), the clipped mean
gradient that the update used (the optimizer's first moment over
1 - beta1), and the update's parameter change, by its norm and element
by element. The change is also held against the reference's AdamW from
the program's own clipped gradient, which checks the optimizer's step by
itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from benchmark import counts, program
from benchmark.reference import sd15_vlcm as R
from benchmark.kinds.story_frame import caption_ids, empty_ids
from benchmark.weights import spec_of, sub_seed

MICRO = 21


class TrainStep:
    unit = "samples"
    job = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 dtype=torch.bfloat16):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev, self.dtype = device, dtype
        self.b, self.n = traffic["batch"], traffic["refs"]
        self.px = cfg["training"]["image_size"]
        self.hw = self.px // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        self.k = cfg["training"]["gradient_accumulation_steps"]
        self.micro = 0           # micro-steps taken
        self.losses: List[float] = []
        self.kept: Dict[int, List[int]] = {}
        self.saved: Dict[str, Dict[str, torch.Tensor]] = {}
        self.profile_from: Optional[int] = None
        self.prof = None
        self.profiled_kept: List[List[int]] = []

    # ------------------------------------------------------------ inputs
    def inputs(self, m: int):
        """Micro-step m's batch and draws."""
        g = torch.Generator(device=self.dev).manual_seed(
            sub_seed(self.seed, MICRO, m))
        b, n, px, hw, dev = self.b, self.n, self.px, self.hw, self.dev
        tr = self.traffic
        lat = (b, hw, hw, self.cfg["unet"]["in_channels"])

        def uniform(shape):
            return torch.rand(shape, generator=g, device=dev) * 2 - 1

        batch = {"image": uniform((b, px, px, 3)),
                 "mask": (torch.rand((b, px, px, 1), generator=g, device=dev)
                          < tr["mask_share"]).float(),
                 "input_ids": caption_ids(g, b, self.cfg,
                                          tr["caption_tokens"], dev),
                 "ref_images": uniform((n, b, px, px, 3)),
                 "ref_input_ids": caption_ids(
                     g, n * b, self.cfg, tr["caption_tokens"],
                     dev).reshape(n, b, -1)}
        empty = empty_ids(self.cfg, dev)
        drop = torch.rand((b,), generator=g, device=dev) < tr["prompt_dropout"]
        batch["input_ids"] = torch.where(drop[:, None], empty,
                                         batch["input_ids"])
        drop = torch.rand((b,), generator=g, device=dev) < tr["ref_dropout"]
        batch["ref_images"] = batch["ref_images"] * (~drop).float()[
            None, :, None, None, None]
        batch["ref_input_ids"] = torch.where(drop[None, :, None], empty,
                                             batch["ref_input_ids"])
        probs = torch.tensor(self.cfg["training"]["ref_keep_probs"],
                             device=dev)
        k0 = torch.multinomial(probs, b, replacement=True, generator=g)
        draws = {
            "posterior_noise": torch.randn(lat, generator=g, device=dev),
            "noise": torch.randn(lat, generator=g, device=dev),
            "t": torch.randint(0, self.cfg["scheduler"]["num_train_timesteps"],
                               (b,), generator=g, device=dev),
            "ref_posterior_noise": torch.randn((n * b,) + lat[1:],
                                               generator=g, device=dev),
            "ref_noise": torch.randn(lat, generator=g, device=dev),
            "ref_mask": torch.arange(n, device=dev)[None] >= k0[:, None]}
        return batch, draws

    # ------------------------------------------------------------ program
    def train_config(self):
        from storygen_tpu_torch.configs import TrainConfig
        tr = self.cfg["training"]
        names = {f.name for f in dataclasses.fields(TrainConfig)}
        return TrainConfig(**{k: v for k, v in tr.items() if k in names
                              and k not in ("stage", "mixed_precision")},
                           mixed_precision="bf16")

    def setup(self) -> None:
        from storygen_tpu_torch.configs import SchedulerConfig
        from storygen_tpu_torch.training import trainer
        self.models = program.build(self.cfg, self.seed, self.dev,
                                    self.dtype)
        self.specs = {k: spec_of(m) for k, m in self.models.items()}
        tc = self.train_config()
        self.models["unet"].gradient_checkpointing = tc.remat
        s = self.cfg["scheduler"]
        bundle = dict(self.models, scheduler_config=SchedulerConfig(
            **{k: s[k] for k in ("num_train_timesteps", "beta_start",
                                 "beta_end", "beta_schedule",
                                 "set_alpha_to_one", "steps_offset",
                                 "clip_sample", "prediction_type")}))
        self.step_fn, self.opt = trainer.make_stage_step(
            self.cfg["training"]["stage"], tc, bundle, self.dev)

    def host(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: t.detach().float().cpu().clone() for n, t in tensors.items()}

    def warm_up(self) -> None:
        """Micro-steps up to and including the first optimizer update,
        keeping what the check compares."""
        self.saved["init"] = self.host(self.opt.params)
        for m in range(self.k):
            self.call(m, warm=True)
            if m == 0:
                self.saved["grad1"] = self.host(self.opt.acc)
        self.saved["after"] = self.host(self.opt.params)
        b1 = self.cfg["training"]["adam_beta1"]
        self.saved["clipped"] = {n: t / (1 - b1) for n, t in
                                 self.host(self.opt.mu).items()}

    def call(self, m: int, warm: bool = False) -> int:
        """Micro-step m; returns the samples it completed (0 when the loss
        is not finite)."""
        batch, draws = self.inputs(m)
        at = None if self.profile_from is None else m - self.profile_from
        if at in (0, 2):
            self.prof.start()
        out = self.step_fn(batch, torch.Generator(device=self.dev), draws)
        loss = float(out["loss"])  # waits for the step, as the trainer does
        self.kept[m] = draws["ref_mask"].sum(1).tolist()
        if at in (1, 2):
            self.prof.stop()
        if at == 1:
            self.profiled_kept = [self.kept[m - 1], self.kept[m]]
        if warm:
            self.losses.append(loss)
        self.micro = m + 1
        return self.b if loss == loss and abs(loss) != float("inf") else 0

    @property
    def start_index(self) -> int:
        return self.k  # the window continues after the warm-up's steps

    def profile_call(self, prof) -> None:
        """Profile the next two micro-steps (the device alone), then the
        third (host and device)."""
        self.profile_from, self.prof = self.micro, prof

    def vae_ms(self) -> Optional[float]:
        return None

    # ------------------------------------------------------------ counts
    def step_ops(self, kept: List[int]) -> List[counts.Op]:
        return counts.train_step_ops(self.cfg, self.b, self.n, kept, self.px)

    def profiled_ops(self) -> List[counts.Op]:
        return [o for kept in self.profiled_kept for o in self.step_ops(kept)]

    def window_flops(self, done: List[int]) -> float:
        """Model FLOPs of the micro-steps `done`."""
        return sum(counts.flops(self.step_ops(self.kept[m]))
                   for m in done)

    # ------------------------------------------------------------ check
    def release(self) -> None:
        self.models = self.step_fn = self.opt = None

    def reference_steps(self, numerics, half: bool = False) -> dict:
        """The reference's micro-steps 1-k from the initial weights: their
        losses, the first gradient and the clipped mean gradient of the k
        (on the host); `half` leaves out the second half of each batch (a
        fault, for the limits' readings)."""
        from benchmark.reference.numerics import fp32_products
        sd = program.reference_weights(self.specs, self.seed, self.dev,
                                       self.dtype)
        names = set(self.saved["init"])
        frozen = {k: v for part in sd.values() for k, v in part.items()
                  if k not in names}
        trained = {k: sd["unet"][k].clone().requires_grad_(True)
                   for k in names}
        del sd
        mean = {k: torch.zeros_like(p) for k, p in trained.items()}
        losses, grad1 = [], None
        with fp32_products():
            for m in range(self.k):
                for p in trained.values():
                    p.grad = None
                batch, draws = self.inputs(m)
                if half:
                    keep = slice(0, self.b // 2)
                    batch = {k: v[:, keep] if k.startswith("ref_") else
                             v[keep] for k, v in batch.items()}
                    draws = {k: v.reshape((self.n, self.b) + v.shape[1:])[
                        :, keep].reshape((-1,) + v.shape[1:])
                             if k == "ref_posterior_noise" else v[keep]
                             for k, v in draws.items()}
                losses.append(float(R.stage2_grads(
                    numerics, frozen, trained, self.cfg, batch, draws)))
                for k, p in trained.items():
                    mean[k] += p.grad.detach() / self.k
                if m == 0:
                    grad1 = self.host({k: p.grad for k, p in
                                       trained.items()})
        clipped = R.clip_by_global_norm(
            mean, self.cfg["training"]["max_grad_norm"])
        return {"losses": losses, "grad1": grad1,
                "clipped": self.host(clipped)}

    def updated(self, side: dict) -> dict:
        """`side` with the change of the reference's AdamW from its clipped
        gradient."""
        init = self.saved["init"]
        return dict(side, change={
            k: R.adamw_first_update(init[k], g, self.cfg)
            for k, g in side["clipped"].items()})

    def gaps(self, prog: dict, ref: dict) -> Dict[str, float]:
        """prog, ref: losses, grad1, clipped, change. Leaves whose clipped
        reference gradient is nought to rounding count in no change."""
        counted = R.counted_leaves(R.per_leaf_norms(ref["clipped"]))
        out = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(prog["losses"], ref["losses"])),
            "grad1_gap": R.norm_gap(R.per_leaf_norms(prog["grad1"]),
                                    R.per_leaf_norms(ref["grad1"])),
            "clipped_rel": R.diff_gap(prog["clipped"], ref["clipped"],
                                      counted),
            "update_gap": R.norm_gap(R.per_leaf_norms(prog["change"]),
                                     R.per_leaf_norms(ref["change"]),
                                     counted=counted)}
        out["update_rel"] = R.diff_gap(
            prog["change"], self.updated(prog)["change"], counted)
        return out

    def program_side(self) -> dict:
        init, after = self.saved["init"], self.saved["after"]
        return {"losses": self.losses, "grad1": self.saved["grad1"],
                "clipped": self.saved["clipped"],
                "change": {k: after[k] - init[k] for k in init}}

    def check(self, numerics) -> Dict[str, float]:
        """loss_gap: the worst of micro-steps 1-k's |program - reference| /
        |reference| losses; grad1_gap, update_gap: the worst leaf's gap of
        norms (reference.sd15_vlcm.norm_gap) of the first gradient and of
        the update's parameter change; clipped_rel: the worst leaf's
        ||program - reference|| of the clipped mean gradient
        (reference.sd15_vlcm.diff_gap); update_rel: the same of the
        parameter change against the reference's AdamW from the program's
        clipped gradient."""
        self.ref = self.updated(self.reference_steps(numerics))
        return self.gaps(self.program_side(), self.ref)

    def readings(self, low) -> Dict[str, Dict[str, float]]:
        """The limits' upper readings against the float32 reference (the
        check's, when it ran): the reference in `low` precision put in the
        program's place ("control"), with half of each batch left out
        ("half_batch"), with its update's sign flipped ("flipped_update"),
        and with its parameters left unchanged ("unchanged_state")."""
        from benchmark.reference.numerics import Numerics
        ref = getattr(self, "ref", None) or self.updated(
            self.reference_steps(Numerics("fp32")))
        out = {"control": self.gaps(self.updated(self.reference_steps(low)),
                                    ref),
               "half_batch": self.gaps(self.updated(self.reference_steps(
                   Numerics("fp32"), half=True)), ref)}
        flipped = {k: -v for k, v in ref["change"].items()}
        out["flipped_update"] = self.gaps(dict(ref, change=flipped), ref)
        still = {k: torch.zeros_like(v) for k, v in ref["change"].items()}
        out["unchanged_state"] = self.gaps(dict(ref, change=still), ref)
        return out



KIND = TrainStep
