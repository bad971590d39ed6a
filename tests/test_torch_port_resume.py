"""The port's checkpoints and resume (storygen_tpu_torch/checkpoint/torch_io.py
and the trainer), on the port alone: a JAX run restarts its draws and its
loader on resume, so it is no reference here.

A save and a restore round trip bit for bit; a run resumed from checkpoint
1 ends equal, bit for bit, to the uninterrupted 2-step run (the image mode
with AdamW, the precomputed-latent mode with AdamW8bit and CFG dropout);
the exported folder loads back through `pretrained_model_path`, and
`build_models` loads only a folder that was named; the SampleLogger's
PNG holds the pipeline's render; the PNG writer against PIL's decoder.
"""
import io
import os
import shutil

import numpy as np
import pytest
import torch

from storygen_tpu_torch.checkpoint import hf_export, torch_io
from storygen_tpu_torch.configs import (DEFAULT_MODEL_PATH, CLIPTextConfig,
                                        TrainConfig, UNetConfig, VAEConfig)
from storygen_tpu_torch.data.loader import SyntheticStoryDataset, collate
from storygen_tpu_torch.pipeline import StoryGenPipeline
from storygen_tpu_torch.training import trainer
from storygen_tpu_torch.utils.image import encode_png, write_png

UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
            norm_num_groups=4, cross_attention_dim=16)
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=2, latent_channels=4)
CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=8)
IMG, N = 64, 3


def tokenize(prompts):
    """8 ids under the tiny vocabulary, seeded by each prompt."""
    return np.stack([np.random.RandomState(len(p)).randint(0, 64, 8)
                     for p in prompts])


def _bundle(cfg):
    return trainer.build_models(cfg, "cpu", UNetConfig(**UNET),
                                VAEConfig(**VAE), CLIPTextConfig(**CLIP))


def test_checkpoint_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(3)
    torch.randn(5, generator=g)
    state = {"micro_step": 6,
             "trainable": {"a": torch.randn(3, 4),
                           "b": torch.randn(5).to(torch.bfloat16)},
             "optimizer": {"count": 3, "mini_step": 0,
                           "mu": {"a": {"q": torch.randint(
                               -127, 128, (1, 256), dtype=torch.int8),
                               "scale": torch.rand(1, 1)}},
                           "nu": {"a": torch.randint(0, 256, (1, 256),
                                                     dtype=torch.uint8)}},
             "generator": g.get_state()}
    ckpt = str(tmp_path / "ckpt")
    assert torch_io.latest_step(ckpt) is None
    with pytest.raises(FileNotFoundError):
        torch_io.restore_checkpoint(ckpt)
    torch_io.save_checkpoint(ckpt, 2, state)
    torch_io.save_checkpoint(ckpt, 3, {**state, "micro_step": 9})
    # a save that died before its rename, and a folder with no state file
    os.makedirs(os.path.join(ckpt, ".tmp-7-1"))
    os.makedirs(os.path.join(ckpt, "8"))
    assert torch_io.latest_step(ckpt) == 3
    got = torch_io.restore_checkpoint(ckpt, 2)

    def same(a, b):
        if torch.is_tensor(a):
            return a.dtype == b.dtype and torch.equal(a, b)
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        return a == b
    assert same(got, state)
    assert torch_io.restore_checkpoint(ckpt)["micro_step"] == 9
    g2 = torch.Generator().set_state(got["generator"])
    assert torch.equal(torch.randn(4, generator=g2),
                       torch.randn(4, generator=g))


def _latents(root):
    os.makedirs(root)
    rs = np.random.RandomState(0)
    for i in range(5):
        m = np.concatenate([rs.randn(8, 8, 4), rs.uniform(-6, -1, (8, 8, 4))],
                           -1)
        r = np.concatenate([rs.randn(N, 8, 8, 4),
                            rs.uniform(-6, -1, (N, 8, 8, 4))], -1)
        np.savez_compressed(
            os.path.join(root, f"{i:08d}.npz"),
            latent_moments=m.astype(np.float16),
            ref_latent_moments=r.astype(np.float16),
            mask=(rs.rand(IMG, IMG, 1) > 0.8).astype(np.float16),
            input_ids=rs.randint(0, 64, 8), ref_input_ids=rs.randint(
                0, 64, (N, 8)))
    return root


@pytest.mark.parametrize("mode", ["image", "precomputed"])
def test_resumed_run_equals_the_uninterrupted_one(mode, tmp_path):
    """Checkpoints every optimizer step; the resumed run starts from a copy
    of the uninterrupted run's checkpoint 1 in a fresh logdir."""
    eightbit = mode == "precomputed"
    kw = dict(train_batch_size=2, gradient_accumulation_steps=2,
              learning_rate=1e-3, mixed_precision="fp32", seed=3,
              checkpointing_steps=1, export_steps=2, loader_threads=2,
              use_8bit_adam=eightbit)
    if eightbit:
        kw["latents_path"] = _latents(str(tmp_path / "latents"))
        data = None
    else:
        data = SyntheticStoryDataset(5, size=IMG, seed=4, vocab_size=64,
                                     max_length=8)

    def run(logdir, steps):
        cfg = TrainConfig(logdir=str(logdir), train_steps=steps, **kw)
        return trainer.train("stage2", cfg, data, device="cpu",
                             models_bundle=_bundle(cfg), tokenizer=tokenize)

    full = run(tmp_path / "full", 2)
    assert sorted(os.listdir(tmp_path / "full" / "checkpoints")) == ["1", "2"]
    os.makedirs(tmp_path / "resumed" / "checkpoints")
    shutil.copytree(tmp_path / "full" / "checkpoints" / "1",
                    tmp_path / "resumed" / "checkpoints" / "1")
    resumed = run(tmp_path / "resumed", 2)
    assert len(full.losses) == 4 and resumed.losses == full.losses[2:]
    assert resumed.optimizer.count == full.optimizer.count == 2
    for k, p in full.trainable.items():
        assert torch.equal(p, resumed.trainable[k]), k
    a, b = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for key in ("mu", "nu"):
        for k in a[key]:
            x, y = a[key][k], b[key][k]
            pairs = x.items() if isinstance(x, dict) else [("", x)]
            for part, v in pairs:
                w = y[part] if part else y
                assert torch.equal(v, w), (key, k, part)
    # only step 2 is exported (export_steps 2)
    assert not (tmp_path / "full" / "checkpoint_1").exists()
    if not eightbit:
        return
    # the export loads back as the trained models
    cfg = TrainConfig(mixed_precision="fp32",
                      pretrained_model_path=str(tmp_path / "full"
                                                / "checkpoint_2"))
    back = trainer.build_models(cfg, "cpu")
    assert back["unet_config"] == UNetConfig(**UNET)
    live = resumed.optimizer.params
    unet = back["unet"].state_dict()
    assert all(torch.equal(unet[k], v) for k, v in live.items())


def _unet_equal(a, b):
    sa, sb = a["unet"].state_dict(), b["unet"].state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_build_models_loads_only_a_named_folder(tmp_path, monkeypatch):
    folder = _bundle(TrainConfig(mixed_precision="fp32", seed=1))
    hf_export.save_pretrained(str(tmp_path / DEFAULT_MODEL_PATH),
                              unet=folder["unet"], vae=folder["vae"],
                              text_encoder=folder["text_encoder"])
    monkeypatch.chdir(tmp_path)
    # a folder at the default path, where the run starts, changes nothing
    cfg = TrainConfig(mixed_precision="fp32", seed=2)
    seeded = _bundle(cfg)
    assert _unet_equal(seeded, trainer.build_models(
        cfg, "cpu", UNetConfig(**UNET), VAEConfig(**VAE),
        CLIPTextConfig(**CLIP)))
    assert not _unet_equal(seeded, folder)
    # named, it loads, and a config that differs from the folder's raises
    named = TrainConfig(mixed_precision="fp32", seed=2,
                        pretrained_model_path=os.path.abspath(
                            DEFAULT_MODEL_PATH))
    assert _unet_equal(folder, trainer.build_models(
        named, "cpu", UNetConfig(**UNET)))
    with pytest.raises(ValueError, match="vae_config"):
        trainer.build_models(named, "cpu",
                             vae_config=VAEConfig(**VAE, scaling_factor=1.0))


def test_sample_logger_writes_the_render(tmp_path):
    cfg = TrainConfig(mixed_precision="fp32", seed=1)
    b = _bundle(cfg)
    pipe = StoryGenPipeline(b["unet"], b["vae"], b["text_encoder"], tokenize,
                            device="cpu")
    kw = dict(num_inference_steps=1, guidance_scale=7.0, height=IMG,
              width=IMG)
    logger = trainer.SampleLogger(pipe, str(tmp_path), **kw)
    rs = np.random.RandomState(0)
    sample = {"prompt": "a fox", "ref_images": rs.rand(N, IMG, IMG, 3)
              .astype(np.float32), "ref_prompts": ["a", "bb", "ccc"]}
    paths = logger.log_sample_images(collate([sample]), 4)
    assert paths == [os.path.join(str(tmp_path), "samples", "step4_0.png")]
    from PIL import Image
    got = np.asarray(Image.open(paths[0]))
    want = pipe("auto-regressive", ["a fox"], image_prompt=sample[
        "ref_images"][:, None], prev_prompt=[["a"], ["bb"], ["ccc"]],
        generator=torch.Generator().manual_seed(4), image_guidance_scale=3.5,
        **kw)
    np.testing.assert_array_equal(got, (want[0] * 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(5, 7, 3), (16, 9, 3), (4, 6)])
def test_png_writer_matches_pil(shape, tmp_path):
    from PIL import Image
    a = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(
        np.uint8)
    got = np.asarray(Image.open(io.BytesIO(encode_png(a))))
    np.testing.assert_array_equal(got, a)
    write_png(str(tmp_path / "a.png"), a)
    Image.fromarray(a).save(tmp_path / "b.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))
    with pytest.raises(ValueError):
        encode_png(a.astype(np.float32))


def test_trainer_refuses_a_dataset_and_latents_path(tmp_path):
    cfg = TrainConfig(logdir=str(tmp_path), latents_path=str(tmp_path))
    with pytest.raises(ValueError, match="not both"):
        trainer.train("stage2", cfg, [1], device="cpu")
