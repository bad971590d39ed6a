"""Rank processes of the port's parallel tests
(tests/test_torch_port_parallel_*.py).

`run_ranks(name, world, tmp_path, **kw)` starts `world` fresh interpreters
running this module; each joins a gloo process group through a FileStore
under tmp_path (no TCP port, so tests under xdist cannot collide), runs
RANK_FNS[name](mesh-less rank, world, **kw) on 2 torch threads and saves
what it returns; the results come back in rank order. The ranks import the
port and torch only, never JAX. A rank that fails or hangs fails the
test."""
import os
import subprocess
import sys
from typing import Any, Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def run_ranks(name: str, world: int, tmp_path, timeout: int = TIMEOUT,
              **kw) -> List[Any]:
    work = os.path.join(str(tmp_path), f"ranks_{name}")
    os.makedirs(work, exist_ok=True)
    torch.save(kw, os.path.join(work, "args.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port_ranks", name, str(r),
         str(world), work], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {name} failed:\n{out}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- the ranks

def tiny_unet(cfg: dict, seed: int, conv=None):
    from storygen_tpu_torch.configs import ConvKernels, UNetConfig
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    return init_random_(UNet2DConditionModel(
        UNetConfig(**cfg), conv or ConvKernels()), seed).eval()


def tiny_vae(cfg: dict, seed: int):
    from storygen_tpu_torch.configs import VAEConfig
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.vae import AutoencoderKL
    return init_random_(AutoencoderKL(VAEConfig(**cfg)), seed).eval()


def unet_forward(rank, world, cfg, seed, x, t, text, refs, ref_t, ref_text,
                 ref_mask, fused=False):
    """The tiny UNet sharded over `world` tensor ranks: a reference pass
    that collects the context of `refs`, then the image cycle under
    `ref_mask`; returns eps, the context and the all-reduces of each
    pass."""
    from storygen_tpu_torch.configs import ConvKernels
    from storygen_tpu_torch.parallel import tensor as T
    unet = tiny_unet(cfg, seed, ConvKernels(fused, fused))
    tp = T.shard_unet_params(unet, T.make_tp_mesh(1, world)) or \
        T.TensorParallel(T.make_tp_mesh(1, 1))  # unsharded: counts 0
    n, b = refs.shape[:2]
    with torch.no_grad():
        _, raw = unet(refs.reshape((n * b,) + refs.shape[2:]), ref_t,
                      ref_text.reshape((n * b,) + ref_text.shape[2:]))
        ref_reduces = tp.allreduces
        ctx = {k: v.reshape((n, b) + v.shape[1:]).transpose(0, 1)
               .reshape(b, n * v.shape[1], v.shape[2])
               for k, v in raw.items()}
        eps, _ = unet(x, t, text, ctx, ref_mask)
    return {"eps": eps, "ctx": ctx, "ref_reduces": ref_reduces,
            "main_reduces": tp.allreduces - ref_reduces}


def vae_forward(rank, world, cfg, seed, image, z):
    from storygen_tpu_torch.parallel import tensor as T
    vae = tiny_vae(cfg, seed)
    T.shard_vae_params(vae, T.make_tp_mesh(1, world))
    with torch.no_grad():
        dist_ = vae.encode(image)
        return {"mean": dist_.mean, "logvar": dist_.logvar,
                "decode": vae.decode(z)}


# tiny stage-2 models: tests/test_torch_port_train_step.py's widths, with
# one layer per block and attention at the two middle levels only (7
# transformer blocks; the JAX step's compile is half the full layout's)
STEP_UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
                 norm_num_groups=4, cross_attention_dim=16,
                 layers_per_block=1,
                 down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                   "CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                                 "CrossAttnUpBlock2D", "UpBlock2D"))
# its attn3 tensors: 7 blocks x (to_q, to_k, to_v, to_out weight and bias)
STEP_ATTN3 = 7 * 5
STEP_VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=2, latent_channels=4)
STEP_CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                 num_hidden_layers=1, num_attention_heads=2,
                 max_position_embeddings=8)


# as tests/test_torch_port_train_step.py: eps 1e-4 bounds Adam's
# sensitivity, so the updated parameters hold to 1e-6
STEP_TRAIN = dict(gradient_accumulation_steps=1, learning_rate=1e-3,
                  adam_epsilon=1e-4)
NUM_REFS = 3


def step_inputs(b: int = 4, img: int = 64):
    """A seeded global stage-2 batch of b rows and the draws of two
    steps."""
    n = NUM_REFS
    rs = np.random.RandomState(0)
    batch = {
        "image": (rs.randn(b, img, img, 3) * 0.2).astype(np.float32),
        "mask": (rs.rand(b, img, img, 1) > 0.8).astype(np.float32),
        "input_ids": rs.randint(0, 64, (b, 8)),
        "ref_images": (rs.randn(n, b, img, img, 3) * 0.2).astype(np.float32),
        "ref_input_ids": rs.randint(0, 64, (n, b, 8))}
    lat = (b, img // 8, img // 8, 4)
    draws = []
    for s in (1, 2):
        g = torch.Generator().manual_seed(s)
        draws.append({
            "posterior_noise": torch.randn(lat, generator=g),
            "noise": torch.randn(lat, generator=g),
            "t": torch.randint(0, 1000, (b,), generator=g),
            "ref_posterior_noise": torch.randn((n * b,) + lat[1:],
                                               generator=g),
            "ref_noise": torch.randn(lat, generator=g),
            "ref_mask": torch.tensor([[0, 0, 1], [0, 1, 1], [1, 1, 1],
                                      [0, 0, 1]][:b], dtype=torch.bool)})
    return batch, draws


def step_bundle(seed: int = 0):
    from storygen_tpu_torch.configs import (CLIPTextConfig, TrainConfig,
                                            UNetConfig, VAEConfig)
    from storygen_tpu_torch.training import trainer
    return trainer.build_models(
        TrainConfig(mixed_precision="fp32", seed=seed), "cpu",
        UNetConfig(**STEP_UNET), VAEConfig(**STEP_VAE),
        CLIPTextConfig(**STEP_CLIP))


def train_steps(batch, draws, train_kw, steps=1, mesh=None, tensor=False,
                seed=0):
    """`steps` stage-2 steps of the tiny models on this rank's rows of the
    global `batch` (numpy) with the global `draws` of each step; on a
    (data, tensor) mesh with `tensor`, the UNet sharded. Returns the
    per-step metrics, the bundle and the optimizer."""
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.parallel import mesh as M
    from storygen_tpu_torch.parallel import tensor as T
    from storygen_tpu_torch.training import trainer
    bundle = step_bundle(seed)
    cfg = TrainConfig(**train_kw)
    if tensor:
        step, opt = T.make_train_step_tp(bundle, cfg, mesh)
    else:
        step, opt = trainer.make_stage_step("stage2", cfg, bundle,
                                            torch.device("cpu"), mesh=mesh)
    local = batch if mesh is None else M.shard_batch(batch, mesh)
    local = {k: torch.as_tensor(v) for k, v in local.items()}
    metrics = [step(local, torch.Generator().manual_seed(0), d)
               for d in draws[:steps]]
    return metrics, bundle, opt


def dp_step(rank, world, batch, draws, train_kw, steps=1):
    """The data-parallel step over `world` ranks: loss, grad_norm and the
    updated attn3 parameters."""
    from storygen_tpu_torch.parallel import mesh as M
    metrics, _, opt = train_steps(batch, draws, train_kw, steps,
                                  M.make_mesh(world))
    return {"metrics": metrics, "params": dict(opt.params)}


def tp_step(rank, world, batch, draws, train_kw, data, steps=1,
            ckpt_dir=None):
    """The step on a (data, tensor) mesh: per-step metrics, the updated
    attn3 parameters gathered whole and, with AdamW8bit, the scales of
    their moments' blocks. With `ckpt_dir`, also the TP
    checkpoint round trip: after step 1 the coordinator saves the full
    trainable tensors and optimizer state; a fresh sharded run restores
    its shards from them (tp_place) and takes step 2, whose parameters
    come back as "resumed"; and the sharded UNet is exported whole to
    <ckpt_dir>/export."""
    from storygen_tpu_torch.checkpoint import torch_io
    from storygen_tpu_torch.parallel import multihost
    from storygen_tpu_torch.parallel import tensor as T
    mesh = T.make_tp_mesh(data, world // data)
    metrics, bundle, opt = train_steps(batch, draws, train_kw, 1, mesh,
                                       tensor=True)
    plan, tp = bundle["unet"].tp_plan, bundle["unet"].tp
    out = {"plan": plan}
    if ckpt_dir is not None:
        state = opt.state_dict()
        full = {"trainable": T.full_tensors(dict(opt.params), plan, tp),
                **{k: T.full_tensors(state[k], plan, tp)
                   for k in ("acc", "mu", "nu")},
                "count": state["count"], "mini_step": state["mini_step"]}
        if multihost.is_coordinator():
            torch_io.save_checkpoint(ckpt_dir, 1, full)
        multihost.barrier()
    local = {k: torch.as_tensor(v)
             for k, v in T.tp_shard_batch(batch, mesh).items()}
    for d in draws[1:steps]:
        metrics.append(_step_again(bundle, opt, train_kw, mesh, local, d))
    out["metrics"] = metrics
    out["params"] = T.full_tensors(dict(opt.params), plan, tp)
    if train_kw.get("use_8bit_adam"):  # each moment's block scales
        out["scales"] = {n: (opt.mu[n].scale, opt.nu[n].scale)
                         for n in opt.params}
    if ckpt_dir is not None:
        from storygen_tpu_torch.checkpoint import hf_export
        hf_export.save_pretrained(os.path.join(ckpt_dir, "export"),
                                  unet=bundle["unet"])
        saved = torch_io.restore_checkpoint(ckpt_dir, 1)
        _, bundle2, opt2 = train_steps(batch, [], train_kw, 0, mesh,
                                       tensor=True)
        with torch.no_grad():
            for n, t in T.tp_place(saved["trainable"], plan, tp).items():
                opt2.params[n].copy_(t)
        opt2.load_state_dict({
            "count": saved["count"], "mini_step": saved["mini_step"],
            **{k: T.tp_place(saved[k], plan, tp)
               for k in ("acc", "mu", "nu")}})
        _step_again(bundle2, opt2, train_kw, mesh, local, draws[1])
        out["resumed"] = T.full_tensors(dict(opt2.params), plan, tp)
    return out


def _step_again(bundle, opt, train_kw, mesh, local, draws):
    """One more stage-2 step of a sharded bundle with its optimizer."""
    from storygen_tpu_torch.diffusion import schedule as S
    from storygen_tpu_torch.training import steps as ST
    step = ST.make_train_step(
        bundle["unet"], bundle["vae"], bundle["text_encoder"],
        S.make_schedule(bundle["scheduler_config"]), opt, stage="stage2",
        mesh=mesh)
    return step(local, torch.Generator().manual_seed(0), draws)


def sample_dp(rank, world, unet_cfg, vae_cfg, seed, args, kw):
    """sample_data_parallel of the tiny serving models over `world`
    ranks."""
    from storygen_tpu_torch.parallel import mesh as M
    from storygen_tpu_torch.parallel.serving import sample_data_parallel
    from storygen_tpu_torch.pipeline import StoryGenSampler
    sampler = StoryGenSampler(tiny_unet(unet_cfg, seed),
                              tiny_vae(vae_cfg, seed + 1), device="cpu")
    return sample_data_parallel(sampler, M.make_mesh(world), *args, **kw)


def mesh_layouts(rank, world, meshes):
    """For each (shape, axis names) in `meshes` (made in order by every
    rank): this rank's coordinates, its batch split (ranks, index), each
    axis group's (sum of its ranks, size) and its rows of a batch sharded
    by key name."""
    from storygen_tpu_torch.parallel import mesh as M
    out = []
    for shape, names in meshes:
        mesh = (M.make_hybrid_mesh(shape[0])
                if tuple(names) == (M.DCN_AXIS, M.DATA_AXIS)
                else M.Mesh(shape, names))
        got = {"coords": mesh.coords,
               "batch": (mesh.size(*mesh.batch_axes),
                         mesh.index(*mesh.batch_axes))}
        for axes in [(a,) for a in names] + [mesh.batch_axes]:
            t = torch.tensor([float(rank)])
            torch.distributed.all_reduce(t, group=mesh.group(*axes))
            got[axes] = (int(t.item()), mesh.size(*axes))
        # a B=4 image batch, which a shape rule would take for ref-major
        batch = {"image": np.arange(4 * 3 * 2).reshape(4, 3, 2),
                 "ref_images": np.arange(3 * 4 * 2).reshape(3, 4, 2),
                 "input_ids": np.arange(4 * 8).reshape(4, 8)}
        got["shard"] = M.shard_batch(batch, mesh)
        out.append(got)
    return out


RANK_FNS = {"unet_forward": unet_forward, "vae_forward": vae_forward,
            "dp_step": dp_step, "tp_step": tp_step, "sample_dp": sample_dp,
            "mesh_layouts": mesh_layouts}


def main(argv: List[str]) -> None:
    import torch.distributed as dist
    name, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(2)
    kw: Dict[str, Any] = torch.load(os.path.join(work, "args.pt"),
                                    weights_only=False)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = RANK_FNS[name](rank, world, **kw)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
