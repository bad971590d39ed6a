"""The offline export (storygen_tpu_torch/scripts/export_checkpoint.py), the
counterpart of the JAX package's scripts/export_checkpoint.py, on the CPU.

A tiny stage-2 run from a base folder, with a checkpoint every optimizer
step and the in-loop export at step 2 (in fp32 and in bf16, whose export
mixes the trained fp32 tensors with the rest in bf16): the offline export
of step 2 equals the in-loop `checkpoint_2` tensor for tensor, dtype
included, and config for config; the offline export of step 1, which has
no in-loop twin, loads in the port and in the JAX package's
`load_diffusers_pretrained`, and both UNets agree on seeded inputs (fp32,
1e-4). `--stage full` takes every UNet tensor from the checkpoint; a
checkpoint tensor outside the stage's subset, or one the base lacks, or a
subset tensor the checkpoint lacks, raises; a base UNet without attn3 goes
through the VLCM surgery; the command line defaults to the latest step.
"""
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.checkpoint import hf_import as j_import
from storygen_tpu.models.clip_text import CLIPTextModel as JCLIP
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu_torch.checkpoint import hf_export, hf_import, torch_io
from storygen_tpu_torch.configs import (CLIPTextConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.data.loader import SyntheticStoryDataset
from storygen_tpu_torch.scripts import export_checkpoint
from storygen_tpu_torch.training import trainer
from tests.torch_port_util import assert_close

UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
            norm_num_groups=4, cross_attention_dim=16)
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=2, latent_channels=4)
CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=8)
WEIGHTS = (("unet", "diffusion_pytorch_model.bin"),
           ("vae", "diffusion_pytorch_model.bin"),
           ("text_encoder", "pytorch_model.bin"))
CONFIGS = ("unet/config.json", "vae/config.json", "text_encoder/config.json",
           "scheduler/scheduler_config.json", "model_index.json")


def tokenize(prompts):
    """8 ids under the tiny vocabulary, seeded by each prompt."""
    return np.stack([np.random.RandomState(len(p)).randint(0, 64, 8)
                     for p in prompts])


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _base(root, precision):
    """A base folder of tiny seeded models in the run's dtype, with a
    tokenizer/ the export copies."""
    cfg = TrainConfig(mixed_precision=precision, seed=5)
    b = trainer.build_models(cfg, "cpu", UNetConfig(**UNET), VAEConfig(**VAE),
                             CLIPTextConfig(**CLIP))
    hf_export.save_pretrained(root, unet=b["unet"], vae=b["vae"],
                              text_encoder=b["text_encoder"],
                              scheduler_config=b["scheduler_config"])
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w") as f:
        json.dump({"a": 0}, f)
    return root


@functools.lru_cache(maxsize=None)
def _run(root, precision):
    """A 2-step stage-2 run from the base folder with a checkpoint every
    step and the in-loop export at step 2: (base, logdir)."""
    base = _base(os.path.join(root, "base"), precision)
    logdir = os.path.join(root, "run")
    cfg = TrainConfig(pretrained_model_path=base, logdir=logdir,
                      train_steps=2, train_batch_size=2,
                      gradient_accumulation_steps=1, learning_rate=1e-3,
                      mixed_precision=precision, seed=3,
                      checkpointing_steps=1, export_steps=2, loader_threads=2)
    data = SyntheticStoryDataset(4, size=64, seed=4, vocab_size=64,
                                 max_length=8)
    trainer.train("stage2", cfg, data, device="cpu", tokenizer=tokenize)
    return base, logdir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    return lambda precision: _run(str(root / precision), precision)


def _weights(root):
    return {sub: hf_import.load_state_dict_file(os.path.join(root, sub, f))
            for sub, f in WEIGHTS}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_offline_export_equals_the_in_loop_export(runs, precision, tmp_path):
    base, logdir = runs(precision)
    out = str(tmp_path / "offline")
    assert export_checkpoint.export(
        base, os.path.join(logdir, "checkpoints"), out, "stage2", 2) == 2
    got, want = _weights(out), _weights(os.path.join(logdir,
                                                      "checkpoint_2"))
    for sub in want:
        assert set(got[sub]) == set(want[sub]), sub
        for k, v in want[sub].items():
            assert got[sub][k].dtype == v.dtype, (sub, k)
            assert torch.equal(got[sub][k], v), (sub, k)
    for name in CONFIGS:
        with open(os.path.join(out, name)) as f, open(
                os.path.join(logdir, "checkpoint_2", name)) as g:
            assert json.load(f) == json.load(g), name
    # the trained subset in its fp32, the rest in the run's dtype
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    for k, v in got["unet"].items():
        assert v.dtype == (torch.float32 if "attn3" in k else dtype), k
    assert os.path.isfile(os.path.join(out, "tokenizer", "vocab.json"))


def _shapes_only(init):
    """A module init that returns zeros of the init's shapes."""
    def fake(self, *args, **kw):
        s = jax.eval_shape(functools.partial(init, self), *args, **kw)
        return jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                      s)
    return fake


def test_offline_export_of_a_step_without_twin_loads_in_both_packages(
        runs, tmp_path, monkeypatch):
    """Step 1 has no in-loop export: its offline folder holds checkpoint
    1's trained tensors and the base's others, loads in the port and in
    the JAX package (whose loader takes shape templates from eval_shape),
    and both UNets give the same eps on seeded inputs."""
    base, logdir = runs("fp32")
    assert not os.path.exists(os.path.join(logdir, "checkpoint_1"))
    out = str(tmp_path / "step1")
    export_checkpoint.export(base, os.path.join(logdir, "checkpoints"), out,
                             "stage2", 1)
    trained = torch_io.restore_checkpoint(os.path.join(logdir, "checkpoints"),
                                          1)["trainable"]
    got, was = _weights(out)["unet"], _weights(base)["unet"]
    for k, v in got.items():
        assert torch.equal(v, trained[k] if "attn3" in k else was[k]), k
    b = hf_import.load_diffusers_pretrained(out, device="cpu")
    for cls in (JUNet, JVAE, JCLIP):
        monkeypatch.setattr(cls, "init", _shapes_only(cls.init))
    jb = j_import.load_diffusers_pretrained(out)
    rs = np.random.RandomState(7)
    x = rs.randn(1, 8, 8, 4).astype(np.float32)
    text = rs.randn(1, 8, 16).astype(np.float32)
    want, _ = jax.jit(jb["unet"].apply)(jb["unet_params"], jnp.asarray(x),
                                        jnp.asarray([501]),
                                        jnp.asarray(text))
    with torch.no_grad():
        eps, _ = b["unet"](torch.from_numpy(x), torch.tensor([501]),
                           torch.from_numpy(text))
    assert_close(want, eps)


def test_full_stage_takes_every_unet_tensor_from_the_checkpoint(runs,
                                                                tmp_path):
    base, _ = runs("fp32")
    was = _weights(base)
    trained = {k: v + 1.0 for k, v in was["unet"].items()}
    ckpt = str(tmp_path / "checkpoints")
    torch_io.save_checkpoint(ckpt, 7, {"micro_step": 7,
                                       "trainable": trained})
    out = str(tmp_path / "full")
    export_checkpoint.export(base, ckpt, out, "full")
    got = _weights(out)
    assert set(got["unet"]) == set(trained)
    for k, v in trained.items():
        assert torch.equal(got["unet"][k], v), k
    for sub in ("vae", "text_encoder"):
        for k, v in was[sub].items():
            assert torch.equal(got[sub][k], v), (sub, k)
    # a stage that trains less refuses the whole-UNet checkpoint
    with pytest.raises(KeyError, match="not stage2's UNet parameters"):
        export_checkpoint.export(base, ckpt, str(tmp_path / "s2"), "stage2")


def test_names_outside_the_stage_or_the_base_raise(runs, tmp_path):
    base, logdir = runs("fp32")
    ckpts = os.path.join(logdir, "checkpoints")
    # the stage-2 run's attn3 tensors fail stage 1's predicate
    with pytest.raises(KeyError, match="not stage1's UNet parameters"):
        export_checkpoint.export(base, ckpts, str(tmp_path / "a"), "stage1")
    trained = torch_io.restore_checkpoint(ckpts, 2)["trainable"]
    ckpt = str(tmp_path / "checkpoints")
    # a name the base's UNet lacks
    torch_io.save_checkpoint(ckpt, 1, {"trainable": {
        **trained, "up_blocks.9.attn3.to_q.weight": torch.zeros(1)}})
    with pytest.raises(KeyError, match="not stage2's UNet parameters"):
        export_checkpoint.export(base, ckpt, str(tmp_path / "b"), "stage2")
    # a stage-2 tensor the checkpoint lacks
    first = sorted(trained)[0]
    torch_io.save_checkpoint(ckpt, 2, {"trainable": {
        k: v for k, v in trained.items() if k != first}})
    with pytest.raises(KeyError, match="not in the checkpoint"):
        export_checkpoint.export(base, ckpt, str(tmp_path / "c"), "stage2",
                                 2)


def test_base_without_attn3_takes_the_surgery(runs, tmp_path):
    """A vanilla base UNet file (no attn3 / norm4): the export fills norm4
    from norm1, as the loader's surgery does, and attn3 from the
    checkpoint."""
    base, logdir = runs("fp32")
    vanilla = str(tmp_path / "vanilla")
    shutil.copytree(base, vanilla)
    path = os.path.join(vanilla, "unet", "diffusion_pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    torch.save({k: v for k, v in sd.items()
                if ".attn3." not in k and ".norm4." not in k}, path)
    out = str(tmp_path / "out")
    export_checkpoint.export(vanilla, os.path.join(logdir, "checkpoints"),
                             out, "stage2", 2)
    got = _weights(out)["unet"]
    trained = torch_io.restore_checkpoint(os.path.join(logdir, "checkpoints"),
                                          2)["trainable"]
    norm4 = [k for k in got if ".norm4." in k]
    assert norm4 and set(got) == set(sd)
    for k in norm4:
        assert torch.equal(got[k], sd[k.replace(".norm4.", ".norm1.")]), k
    for k, v in trained.items():
        assert torch.equal(got[k], v), k


def test_command_line_exports_the_latest_step(runs, tmp_path, capsys):
    base, logdir = runs("fp32")
    out = str(tmp_path / "cli")
    export_checkpoint.main(["--base", base, "--ckpt",
                            os.path.join(logdir, "checkpoints"), "--out",
                            out])
    assert capsys.readouterr().out.strip() == f"exported step 2 -> {out}"
    got, want = _weights(out), _weights(os.path.join(logdir,
                                                      "checkpoint_2"))
    assert all(torch.equal(got["unet"][k], v)
               for k, v in want["unet"].items())
    with pytest.raises(FileNotFoundError):
        export_checkpoint.export(base, str(tmp_path / "none"),
                                 str(tmp_path / "x"))
