"""Port parity: the precomputed-latent training mode and the DataLoader.

One stage-2 step on stored posterior moments (`latent_moments`,
`ref_latent_moments`) against the JAX package's jitted step on the same
weights and the JAX step's own draws (the refs' posterior noise from
`split(ks[3], N)`, as the JAX step draws it under vmap), with no row
dropped. The port's CFG dropout, which the JAX step does not apply, is
checked on its own with stand-in models: its rates over many rows, and
that a dropped row carries the empty prompt's ids and the moments of the
all-zero image. Then `PrecomputedLatentDataset`, `collate` and the
`DataLoader`'s order, shards, epochs and resume offset against the JAX
package's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from storygen_tpu.checkpoint import hf_import
from storygen_tpu.configs import CLIPTextConfig as JCLIPConfig
from storygen_tpu.configs import SchedulerConfig as JSchedConfig
from storygen_tpu.configs import TrainConfig as JTrainConfig
from storygen_tpu.configs import UNetConfig as JUNetConfig
from storygen_tpu.configs import VAEConfig as JVAEConfig
from storygen_tpu.data import datasets as j_datasets
from storygen_tpu.data import loader as j_loader
from storygen_tpu.diffusion import schedule as JS
from storygen_tpu.models.clip_text import CLIPTextModel as JCLIP
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu.training import optim as j_optim
from storygen_tpu.training import steps as j_steps
from storygen_tpu_torch.checkpoint.convert import jax_to_state_dict
from storygen_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                        TrainConfig, UNetConfig, VAEConfig)
from storygen_tpu_torch.data.datasets import PrecomputedLatentDataset
from storygen_tpu_torch.data.loader import DataLoader, collate
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.models.vae import DiagonalGaussian
from storygen_tpu_torch.training import optim, steps, trainer
from tests.torch_port_util import assert_close, jax_params, np_tree

# the tiny widths of tests/test_torch_port_train_step.py
UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
            norm_num_groups=4, cross_attention_dim=16)
VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
           norm_num_groups=2, latent_channels=4)
CLIP = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=8)
IMG, B, N = 64, 2, 3
LAT = (B, IMG // 8, IMG // 8, 4)
TRAIN = dict(gradient_accumulation_steps=1, learning_rate=1e-3,
             adam_epsilon=1e-4)


def _moments(rs, shape):
    """Stored posterior moments: the mean and a logvar in [-6, -1]."""
    mean = rs.randn(*shape, 4) * 0.5
    logvar = rs.uniform(-6, -1, shape + (4,))
    return np.concatenate([mean, logvar], -1).astype(np.float16)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "latent_moments": _moments(rs, LAT[:3]).astype(np.float32),
        "ref_latent_moments": _moments(rs, (N,) + LAT[:3]).astype(
            np.float32),
        "mask": (rs.rand(B, IMG, IMG, 1) > 0.8).astype(np.float32),
        "input_ids": rs.randint(0, 64, (B, 8)),
        "ref_input_ids": rs.randint(0, 64, (N, B, 8)),
    }


def test_precomputed_stage2_step_matches_jax():
    cfg = TrainConfig(mixed_precision="fp32", seed=0)
    bundle = trainer.build_models(cfg, "cpu", UNetConfig(**UNET),
                                  VAEConfig(**VAE), CLIPTextConfig(**CLIP))
    unet, vae, clip = bundle["unet"], bundle["vae"], bundle["text_encoder"]
    junet = JUNet(config=JUNetConfig(**UNET))
    jvae = JVAE(config=JVAEConfig(**VAE))
    jclip = JCLIP(config=JCLIPConfig(**CLIP))
    rng = jax.random.PRNGKey(0)
    up = jax_params(junet, unet.state_dict(), hf_import.torch_to_flax_unet,
                    jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                    jnp.zeros((1, 8, 16)))
    vp = jax_params(jvae, vae.state_dict(), hf_import.torch_to_flax_vae,
                    jnp.zeros((1, IMG, IMG, 3)), rng)
    cp = jax_params(jclip, clip.state_dict(), hf_import.torch_to_flax_clip,
                    jnp.zeros((1, 8), jnp.int32))
    tx = j_optim.make_optimizer(JTrainConfig(**TRAIN))
    j_train, j_frozen = j_optim.partition_params(
        up, j_optim.STAGE_PREDICATES["stage2"])
    step = j_steps.make_stage2_step(junet, jvae, jclip,
                                    JS.make_schedule(JSchedConfig()), tx)
    batch = _batch()
    key = jax.random.PRNGKey(11)
    new_state, metrics = jax.jit(step)(
        j_steps.init_train_state(j_train, tx),
        j_steps.FrozenBundle(j_frozen, vp, cp),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)

    # the JAX step's draws: the refs' posterior noise is one key per ref
    ks = jax.random.split(key, 6)
    ref_keys = jax.random.split(ks[3], N)
    draws = {
        "posterior_noise": jax.random.normal(ks[0], LAT),
        "noise": jax.random.normal(ks[1], LAT),
        "t": jax.random.randint(ks[2], (B,), 0, 1000),
        "ref_posterior_noise": jnp.concatenate(
            [jax.random.normal(k, LAT) for k in ref_keys]),
        "ref_noise": jax.random.normal(ks[4], LAT),
        "ref_mask": j_steps._sample_ref_mask(ks[5], B, N),
        "prompt_dropout": jnp.zeros((B,), bool),
        "ref_dropout": jnp.zeros((B,), bool),
    }
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    updated = jax_to_state_dict(np_tree(
        j_optim.merge_params(new_state.trainable, j_frozen)))

    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES["stage2"])
    opt = optim.AdamW(trainable, TrainConfig(**TRAIN))
    port_step = steps.make_train_step(
        unet, vae, clip, S.make_schedule(SchedulerConfig()), opt,
        stage="stage2", empty_ids=torch.zeros(8, dtype=torch.long))
    out = port_step({k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.Generator().manual_seed(0), draws)
    assert_close(metrics["loss"], out["loss"], msg="loss")
    assert_close(metrics["grad_norm"], out["grad_norm"], msg="grad_norm")
    for k, p in trainable.items():
        assert_close(updated[k], p, atol=1e-6, rtol=1e-5, msg=k)


class _StubVAE(nn.Module):
    """Encodes any image to mean 3, logvar -2 (the 'all-zero image')."""
    config = SimpleNamespace(scaling_factor=0.5, downscale_factor=8,
                             latent_channels=4)
    dtype = torch.float32

    def encode(self, x):
        self.encoded = tuple(x.shape)
        mean = torch.full(x.shape[:1] + (x.shape[1] // 8, x.shape[2] // 8, 4),
                          3.0)
        return DiagonalGaussian(mean, torch.full_like(mean, -2.0))


class _StubText(nn.Module):
    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, ids):
        self.seen.append(ids.clone())
        return ids.float()[..., None].expand(*ids.shape, 4)


class _StubUNet(nn.Module):
    """Records the reference pass's input (it runs without a graph); the
    main pass is w * sample."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(()))

    def forward(self, sample, t, text, ctx=None, ref_mask=None):
        if not torch.is_grad_enabled():
            self.ref_sample = sample.clone()
            return sample, {"a": sample.reshape(sample.shape[0], -1, 4)}
        return sample * self.w, {}


def _stub_step(empty_ids=torch.full((4,), 9), stage="stage2"):
    unet, vae, text = _StubUNet(), _StubVAE(), _StubText()
    opt = optim.AdamW({"w": unet.w}, TrainConfig(
        gradient_accumulation_steps=1))
    step = steps.make_train_step(unet, vae, text,
                                 S.make_schedule(SchedulerConfig()), opt,
                                 stage=stage, empty_ids=empty_ids)
    return step, unet, vae, text


def test_cfg_dropout_rates_and_dropped_rows():
    rows = 20000
    step, unet, vae, text = _stub_step()
    batch = {"latent_moments": torch.zeros((rows, 1, 1, 8)),
             "ref_latent_moments": torch.zeros((N, rows, 1, 1, 8)),
             "mask": torch.ones((rows, 8, 8, 1)),
             "input_ids": torch.ones((rows, 4), dtype=torch.long),
             "ref_input_ids": torch.full((N, rows, 4), 2)}
    zeros = torch.zeros((N * rows, 1, 1, 4))
    step(batch, torch.Generator().manual_seed(5),
         {"ref_posterior_noise": zeros, "ref_noise": zeros[:rows],
          "t": torch.zeros(rows, dtype=torch.long)})
    main_ids, ref_ids = text.seen
    prompt_dropped = (main_ids == 9).all(dim=1)
    assert ((main_ids == 1).all(dim=1) | prompt_dropped).all()
    ref_ids = ref_ids.reshape(N, rows, 4)
    refs_dropped = (ref_ids == 9).all(dim=2)
    assert ((ref_ids == 2).all(dim=2) | refs_dropped).all()
    # all of a row's refs drop together
    assert (refs_dropped == refs_dropped[0]).all()
    # rates within 5 binomial standard deviations of 5% and 10%
    for dropped, p in ((prompt_dropped, steps.PROMPT_DROPOUT),
                       (refs_dropped[0], steps.REF_DROPOUT)):
        sd = (p * (1 - p) / rows) ** 0.5
        assert abs(dropped.float().mean().item() - p) < 5 * sd
    # a dropped row's refs are sampled from the zero image's moments (the
    # stand-in VAE's mean 3, at t = 0 with zero noise), the others from
    # the batch's (mean 0)
    assert vae.encoded == (1, 8, 8, 3)
    sample = unet.ref_sample.reshape(N, rows, 4)
    acp0 = S.make_schedule(SchedulerConfig()).alphas_cumprod[0]
    want = torch.where(refs_dropped[..., None],
                       (acp0.sqrt() * 3.0 * 0.5).float(), 0.0)
    torch.testing.assert_close(sample, want.expand(N, rows, 4))


def test_stage1_precomputed_drops_prompts_only():
    rows = 20000
    step, unet, vae, text = _stub_step(stage="stage1")
    step({"latent_moments": torch.zeros((rows, 1, 1, 8)),
          "mask": torch.ones((rows, 8, 8, 1)),
          "input_ids": torch.ones((rows, 4), dtype=torch.long)},
         torch.Generator().manual_seed(6))
    (ids,) = text.seen
    dropped = (ids == 9).all(dim=1)
    assert ((ids == 1).all(dim=1) | dropped).all()
    sd = (steps.PROMPT_DROPOUT * (1 - steps.PROMPT_DROPOUT) / rows) ** 0.5
    assert abs(dropped.float().mean().item() - steps.PROMPT_DROPOUT) < 5 * sd
    assert not hasattr(vae, "encoded")  # no refs, no zero image


def test_precomputed_mode_needs_the_empty_prompt():
    step, *_ = _stub_step(empty_ids=None)
    batch = {"latent_moments": torch.zeros((2, 1, 1, 8)),
             "ref_latent_moments": torch.zeros((N, 2, 1, 1, 8)),
             "mask": torch.ones((2, 8, 8, 1)),
             "input_ids": torch.ones((2, 4), dtype=torch.long),
             "ref_input_ids": torch.ones((N, 2, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="empty prompt"):
        step(batch, torch.Generator().manual_seed(0))


def test_precomputed_dataset_and_collate_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    for i in range(3):
        np.savez_compressed(
            tmp_path / f"{i:08d}.npz",
            latent_moments=_moments(rs, (4, 4)),
            ref_latent_moments=_moments(rs, (N, 4, 4)),
            mask=(rs.rand(32, 32, 1) > 0.5).astype(np.float16),
            input_ids=rs.randint(0, 64, 77), ref_input_ids=rs.randint(
                0, 64, (N, 77)))
    ours = PrecomputedLatentDataset(str(tmp_path))
    ref = j_datasets.PrecomputedLatentDataset(str(tmp_path))
    assert len(ours) == len(ref) == 3
    samples = [ours[i] for i in (2, 0)]
    for a, b in zip(samples, [ref[i] for i in (2, 0)]):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got, want = collate(samples), j_loader.collate(samples)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["ref_latent_moments"].shape == (N, 2, 4, 4, 8)
    assert got["ref_input_ids"].dtype == np.int64
    with pytest.raises(FileNotFoundError):
        PrecomputedLatentDataset(str(tmp_path / "none"))


class _Indexed:
    """Item i is its own index; `_rng.set_epoch` calls are recorded."""

    def __init__(self, n):
        self.n = n
        self._rng = SimpleNamespace(epochs=[])
        self._rng.set_epoch = self._rng.epochs.append

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"input_ids": np.asarray([i])}


def _first(loader, count):
    it = iter(loader)
    out = [next(it)["input_ids"][:, 0].tolist() for _ in range(count)]
    if hasattr(it, "close"):
        it.close()
    return out


@pytest.mark.parametrize("n,bs,seed,shards,shard,drop_last", [
    (10, 3, 0, 1, 0, True), (11, 2, 7, 3, 1, True), (9, 4, 5, 1, 0, False),
    (13, 2, 1, 2, 0, True)])
def test_dataloader_order_matches_jax(n, bs, seed, shards, shard, drop_last):
    kw = dict(seed=seed, num_shards=shards, shard_id=shard,
              drop_last=drop_last)
    ours_ds, ref_ds = _Indexed(n), _Indexed(n)
    ours = _first(DataLoader(ours_ds, bs, num_threads=3, **kw), 9)
    ref = _first(j_loader.DataLoader(ref_ds, bs, num_threads=1, **kw), 9)
    assert ours == ref
    assert ours_ds._rng.epochs[:3] == [0, 1, 2]
    # starting at batch 4 skips the first four without loading them
    late = DataLoader(_Indexed(n), bs, prefetch=0, num_threads=1, start=4,
                      **kw)
    assert _first(late, 5) == ours[4:]


def test_dataloader_raises_what_the_dataset_raises():
    class Broken(_Indexed):
        def __getitem__(self, i):
            if i == 3:
                raise OSError("unreadable sample 3")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable sample 3"):
        _first(DataLoader(Broken(6), 6, num_threads=2), 1)
    with pytest.raises(ValueError, match="make no batch"):
        DataLoader(_Indexed(3), 4)
