"""Port parity of data parallelism and the multi-process entry points
(storygen_tpu_torch/parallel/mesh.py, multihost.py, serving.py, the
trainer and scripts/train.py, scripts/serve.py --tp), on the CPU with
gloo ranks as subprocesses (tests/torch_port_ranks.py):

- the (data, tensor) and hybrid (dcn, data) meshes' groups and the batch
  sharded by key name;
- the port's stage-2 step at data 2 against the JAX package's
  `jit_train_step` on `make_mesh(2)`, on the same global batch and the
  JAX step's own draws (rtol 1e-4, as tests/test_training.py holds JAX
  against itself), and the port at data 2 against its one process;
- `sample_data_parallel` over 2 ranks against one process's sample;
- `initialize()` without configuration does nothing;
- train.py with --coordinator / --num_processes / --process_id at world
  2: only rank 0 writes, and a run resumed from its checkpoint ends bit
  for bit as the uninterrupted one;
- serve.py --tp 2: a request's round trip, the frames near one process's
  (bf16 models: rel L2 1e-2), /healthz's device count, and shutdown
  reaching both ranks."""
import base64
import json
import os
import shutil
import re
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import PROMPTS, write_bpe_files, write_storysalon_tree
from storygen_tpu.checkpoint import hf_import
from storygen_tpu.configs import CLIPTextConfig as JCLIPConfig
from storygen_tpu.configs import SchedulerConfig as JSchedConfig
from storygen_tpu.configs import TrainConfig as JTrainConfig
from storygen_tpu.configs import UNetConfig as JUNetConfig
from storygen_tpu.configs import VAEConfig as JVAEConfig
from storygen_tpu.diffusion import schedule as JS
from storygen_tpu.models.clip_text import CLIPTextModel as JCLIP
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu.parallel import mesh as JM
from storygen_tpu.training import optim as j_optim
from storygen_tpu.training import steps as j_steps
from storygen_tpu_torch.checkpoint import torch_io
from storygen_tpu_torch.checkpoint.convert import jax_to_state_dict
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.parallel import multihost
from storygen_tpu_torch.pipeline import StoryGenSampler
from storygen_tpu_torch.scripts.common import load_pipeline
from storygen_tpu_torch.utils.image import decode_png
from tests import torch_port_ranks as R
from tests.torch_port_util import (TINY_UNET, TINY_VAE, cli_folder,
                                   jax_params, np_tree)

REPO = R.REPO
N = R.NUM_REFS
TRAIN = R.STEP_TRAIN


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


MESHES = [((2, 2), ("data", "tensor")), ((2, 2), ("dcn", "data")),
          ((4,), ("data",))]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Every mesh of MESHES as 4 ranks see it (one launch of the ranks)."""
    return R.run_ranks("mesh_layouts", 4, tmp_path_factory.mktemp("mesh"),
                       meshes=MESHES)


@pytest.mark.parametrize("which", range(len(MESHES)))
def test_mesh_groups_and_batch_rows(layouts, which):
    shape, names = MESHES[which]
    ids = np.arange(4).reshape(shape)
    for rank, outs in enumerate(layouts):
        out = outs[which]
        where = np.argwhere(ids == rank)[0]
        assert out["coords"] == dict(zip(names, where.tolist()))
        for i, a in enumerate(names):
            group = np.take(ids, where[1 - i], axis=1 - i) if len(shape) \
                == 2 else ids
            assert out[(a,)] == (int(group.sum()), shape[i]), a
        batch_axes = tuple(a for a in names if a != "tensor")
        n, idx = out["batch"]
        assert n == int(np.prod([shape[names.index(a)] for a in batch_axes]))
        # batch rows by key name: axis 1 of ref_images, axis 0 of the rest
        b = 4 // n
        img = np.arange(4 * 3 * 2).reshape(4, 3, 2)
        np.testing.assert_array_equal(out["shard"]["image"],
                                      img[idx * b:(idx + 1) * b])
        np.testing.assert_array_equal(
            out["shard"]["ref_images"],
            np.arange(3 * 4 * 2).reshape(3, 4, 2)[:, idx * b:(idx + 1) * b])


def _jax_models(bundle):
    unet, vae, clip = bundle["unet"], bundle["vae"], bundle["text_encoder"]
    junet = JUNet(config=JUNetConfig(**R.STEP_UNET))
    jvae = JVAE(config=JVAEConfig(**R.STEP_VAE))
    jclip = JCLIP(config=JCLIPConfig(**R.STEP_CLIP))
    up = jax_params(junet, unet.state_dict(), hf_import.torch_to_flax_unet,
                    jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                    jnp.zeros((1, 8, 16)))
    vp = jax_params(jvae, vae.state_dict(), hf_import.torch_to_flax_vae,
                    jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(0))
    cp = jax_params(jclip, clip.state_dict(), hf_import.torch_to_flax_clip,
                    jnp.zeros((1, 8), jnp.int32))
    return (junet, up), (jvae, vp), (jclip, cp)


def test_dp_step_matches_jax_jit_train_step(tmp_path):
    """One stage-2 step at global batch 4: the JAX package's step
    data-parallel on make_mesh(2) (XLA's psum), and the port's at data 2
    (each rank 2 rows, the gradients all-reduced), on the same weights and
    the JAX step's draws; then the port at data 2 against its own one
    process."""
    b, img = 4, 64
    batch, _ = R.step_inputs(b, img)
    (junet, up), (jvae, vp), (jclip, cp) = _jax_models(R.step_bundle(0))
    tx = j_optim.make_optimizer(JTrainConfig(**TRAIN))
    j_train, j_frozen = j_optim.partition_params(
        up, j_optim.STAGE_PREDICATES["stage2"])
    step = j_steps.make_stage2_step(junet, jvae, jclip,
                                    JS.make_schedule(JSchedConfig()), tx)
    mesh = JM.make_mesh(2)
    key = jax.random.PRNGKey(7)
    state, metrics = JM.jit_train_step(step, mesh)(
        JM.replicate(j_steps.init_train_state(j_train, tx), mesh),
        JM.replicate(j_steps.FrozenBundle(j_frozen, vp, cp), mesh),
        JM.shard_batch(batch, mesh), key)
    ks = jax.random.split(key, 6)
    lat = (b, img // 8, img // 8, 4)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in {
        "posterior_noise": jax.random.normal(ks[0], lat),
        "noise": jax.random.normal(ks[1], lat),
        "t": jax.random.randint(ks[2], (b,), 0, 1000),
        "ref_posterior_noise": jax.random.normal(ks[3], (N * b,) + lat[1:]),
        "ref_noise": jax.random.normal(ks[4], lat),
        "ref_mask": j_steps._sample_ref_mask(ks[5], b, N)}.items()}
    updated = jax_to_state_dict(np_tree(j_optim.merge_params(
        jax.device_get(state.trainable), j_frozen)))
    outs = R.run_ranks("dp_step", 2, tmp_path, batch=batch, draws=[draws],
                       train_kw=TRAIN)
    one, _, opt = R.train_steps(batch, [draws], TRAIN)
    for rank, out in enumerate(outs):
        m = out["metrics"][0]
        np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(metrics["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["loss"]), float(one[0]["loss"]),
                                   rtol=1e-6)
        assert len(out["params"]) == R.STEP_ATTN3
        for k, p in out["params"].items():
            np.testing.assert_allclose(p.detach().numpy(), updated[k].numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")
            np.testing.assert_allclose(p.detach().numpy(),
                                       opt.params[k].detach().numpy(),
                                       rtol=1e-5, atol=1e-7)


def test_sample_data_parallel_matches_one_sample(tmp_path):
    rs = np.random.RandomState(0)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32))

    b, hw, d = 2, 8, TINY_UNET["cross_attention_dim"]
    args = (r(b, hw, hw, 4), r(b, 7, d), r(b, 7, d), r(N, b, hw, hw, 4,
                                                       scale=0.5),
            r(b, hw, hw, 4, scale=0.05), r(N, b, 7, d), r(N, b, 7, d),
            r(b, hw, hw, 4), 7.5, 3.5)
    kw = dict(stage="auto-regressive", num_inference_steps=2)
    sampler = StoryGenSampler(R.tiny_unet(TINY_UNET, 5),
                              R.tiny_vae(TINY_VAE, 6), device="cpu")
    want = sampler.sample(*args, **kw)
    outs = R.run_ranks("sample_dp", 2, tmp_path, unet_cfg=TINY_UNET,
                       vae_cfg=TINY_VAE, seed=5, args=args, kw=kw)
    for out in outs:  # rows of B = 1 against B = 2: fp32 roundoff
        assert out.shape == want.shape
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_initialize_does_nothing_without_config(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    # a rank whose local rank has no card raises unless given a device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="has no card"):
        multihost.rank_device(None, 1)
    assert multihost.rank_device("cpu", 1) == torch.device("cpu")
    # NCCL never runs on the CPU, and gloo is never a fallback
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        multihost.initialize("127.0.0.1:1", 1, 0, device="cpu")
    with pytest.raises(ValueError, match="needs the coordinator"):
        multihost.initialize(None, 2, 0)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("par") / "ckpt")
    write_bpe_files(root + "_tok", PROMPTS, 200)
    return cli_folder(root, Tokenizer(root + "_tok"))


def _procs(argv, world, store, tmp_path):
    """`world` ranks of `python -m argv...` with the JAX package's
    process environment names over a FileStore."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               JAX_COORDINATOR_ADDRESS=f"file://{store}",
               JAX_NUM_PROCESSES=str(world))
    return [subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=REPO,
        env=dict(env, JAX_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _train_world2(cfg_path, tmp_path, tag):
    """scripts/train.py in 2 processes, with its three flags."""
    store = str(tmp_path / f"store_{tag}")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "storygen_tpu_torch.scripts.train", "--stage",
         "stage2", "--config", cfg_path, "--device", "cpu", "--backend",
         "gloo", "--coordinator", f"file://{store}", "--num_processes", "2",
         "--process_id", str(r)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_train_flags_at_world_2_write_once_and_resume(folder, tmp_path):
    tree = str(tmp_path / "salon")
    write_storysalon_tree(tree, stories=3, frames=4, size=512)
    logdir = str(tmp_path / "log")
    cfg = dict(pretrained_model_path=folder, dataset_path=tree,
               logdir=logdir, train_steps=2, train_batch_size=2,
               gradient_accumulation_steps=1, checkpointing_steps=1,
               loader_threads=1, seed=0, mixed_precision="fp32",
               mesh_shape=[8])
    path = str(tmp_path / "stage2.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    outs = _train_world2(path, tmp_path, "a")
    assert "trains on the 2 it has" in outs[0]
    ckpt = os.path.join(logdir, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["1", "2"]
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        assert [json.loads(x)["step"] for x in f] == [1]  # rank 0 alone
    assert os.path.isdir(os.path.join(logdir, "checkpoint_2", "unet"))
    full = torch_io.restore_checkpoint(ckpt, 2)
    # resume from step 1: the same step 2, bit for bit
    shutil.rmtree(os.path.join(ckpt, "2"))
    outs = _train_world2(path, tmp_path, "b")
    assert all("resumed from step 1" in o for o in outs)
    again = torch_io.restore_checkpoint(ckpt, 2)
    assert again["micro_step"] == full["micro_step"] == 2
    for k, v in full["trainable"].items():
        assert torch.equal(again["trainable"][k], v), k
    for k in ("mu", "nu"):
        for n, v in full["optimizer"][k].items():
            assert torch.equal(again["optimizer"][k][n], v), (k, n)


def test_serve_tp2_round_trip(folder, tmp_path):
    procs = _procs(["storygen_tpu_torch.scripts.serve", "--ckpt", folder,
                    "--tp", "2", "--backend", "gloo", "--device", "cpu",
                    "--port", "0"], 2, str(tmp_path / "store"), tmp_path)
    try:
        base = None
        for line in procs[0].stdout:
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                base = m.group(1)
                break
        assert base, "rank 0 never served"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.load(r) == {"ok": True, "devices": 2}
        req = {"prompts": list(PROMPTS[:2]), "num_inference_steps": 1,
               "height": 64, "width": 64, "seed": 3}
        with urllib.request.urlopen(urllib.request.Request(
                base + "/story", json.dumps(req).encode()),
                timeout=300) as r:
            reply = json.load(r)
        want = load_pipeline(folder, "cpu").generate_story(
            list(PROMPTS[:2]), num_inference_steps=1, height=64, width=64,
            seed=3)
        import base64
        # bf16 models (load_pipeline's dtype): the sharded sums round
        # elsewhere than the whole ones (rel L2 3.3e-3 in floats)
        for got, w in zip(reply["frames"], want):
            img = decode_png(base64.b64decode(got)).astype(np.float64)
            ref = (np.clip(w, 0, 1) * 255).astype(np.uint8).astype(
                np.float64)
            assert np.linalg.norm(img - ref) <= 1e-2 * np.linalg.norm(ref)
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            p.communicate(timeout=120)
            assert p.returncode == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
