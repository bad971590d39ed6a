"""Port parity for the training slice's plain parts, against the JAX
package on the same seeded numpy inputs, fp32: the loss helpers, the
learning-rate schedules, the optimizer (clip + AdamW + gradient
accumulation, against optax over 3 optimizer steps), the ref-mask sampler
and `collate`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.configs import TrainConfig as JTrainConfig
from storygen_tpu.data.loader import collate as j_collate
from storygen_tpu.training import losses as j_losses
from storygen_tpu.training import optim as j_optim
from storygen_tpu_torch.configs import TrainConfig
from storygen_tpu_torch.data.loader import (DataLoader, SyntheticStoryDataset,
                                            collate)
from storygen_tpu_torch.training import losses, optim, steps
from tests.torch_port_util import assert_close, rand, t


def test_downsample_mask_matches_jax():
    m = (np.random.RandomState(0).rand(2, 64, 48, 1)).astype(np.float32)
    assert_close(j_losses.downsample_mask(jnp.asarray(m)),
                 losses.downsample_mask(t(m)), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
def test_masked_mse_matches_jax(with_mask):
    pred, target = rand(1, (2, 8, 8, 4)), rand(2, (2, 8, 8, 4))
    mask = (np.random.RandomState(3).rand(2, 8, 8, 1) > 0.5).astype(
        np.float32) if with_mask else None
    jm, tm = (None, None) if mask is None else (jnp.asarray(mask), t(mask))
    ref = j_losses.masked_mse(jnp.asarray(pred), jnp.asarray(target), jm)
    assert_close(ref, losses.masked_mse(t(pred), t(target), tm))
    # bf16 predictions are read in fp32, as the JAX loss reads them
    got = losses.masked_mse(t(pred).bfloat16(), t(target), tm)
    ref = j_losses.masked_mse(jnp.asarray(pred).astype(jnp.bfloat16),
                              jnp.asarray(target), jm)
    assert got.dtype == torch.float32
    assert_close(ref, got)


SCHEDULES = [dict(lr_scheduler="constant", lr_warmup_steps=2),
             dict(lr_scheduler="constant", lr_warmup_steps=0),
             dict(lr_scheduler="linear", train_steps=5),
             dict(lr_scheduler="cosine", train_steps=5),
             dict(lr_scheduler="constant", scale_lr=True)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_lr_schedule_matches_jax(kw):
    base = dict(learning_rate=1e-3, gradient_accumulation_steps=2,
                train_batch_size=3, **kw)
    for step in range(7):
        np.testing.assert_allclose(
            optim.lr_at(TrainConfig(**base), step),
            j_optim.lr_at(JTrainConfig(**base), step), rtol=1e-6)


@pytest.mark.parametrize("kw", SCHEDULES[:1] + SCHEDULES[2:4])
def test_optimizer_matches_optax(kw):
    """clip-by-global-norm -> AdamW -> 2-step accumulation, 3 optimizer
    steps (6 micro-steps), grads large enough to clip on some steps."""
    base = dict(learning_rate=1e-2, gradient_accumulation_steps=2,
                adam_weight_decay=0.1, max_grad_norm=1.0, **kw)
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rand(80 + i, s) for i, (k, s) in enumerate(shapes.items())}
    tx = j_optim.make_optimizer(JTrainConfig(**base))
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    params = {k: t(v) for k, v in init.items()}
    opt = optim.AdamW(params, TrainConfig(**base))
    for micro in range(6):
        scale = 3.0 if micro % 3 == 0 else 0.05  # clip, then not
        grads = {k: rand(100 + 10 * micro + i, s, scale)
                 for i, (k, s) in enumerate(shapes.items())}
        upd, j_state = tx.update({k: jnp.asarray(v)
                                  for k, v in grads.items()},
                                 j_state, j_params)
        j_params = {k: j_params[k] + upd[k] for k in j_params}
        applied = opt.update({k: t(v) for k, v in grads.items()})
        assert applied == (micro % 2 == 1)
        for k in shapes:
            assert_close(j_params[k], params[k], atol=1e-6, rtol=1e-5,
                         msg=f"{k} after micro-step {micro}")
    assert opt.count == 3


def test_partition_freezes_all_but_attn3():
    from storygen_tpu_torch.configs import UNetConfig
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    unet = UNet2DConditionModel(UNetConfig(
        block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
        norm_num_groups=2, cross_attention_dim=8))
    trainable = optim.partition_params(unet,
                                       optim.STAGE_PREDICATES["stage2"])
    assert len(trainable) == 16 * 5 and all("attn3" in n for n in trainable)
    for name, p in unet.named_parameters():
        assert p.requires_grad == ("attn3" in name)


def test_ref_mask_distribution():
    g = torch.Generator().manual_seed(0)
    m = steps.sample_ref_mask(g, 4096, 3).numpy()
    assert m.dtype == bool and m.shape == (4096, 3)
    assert m[:, 2].all()  # the newest ref is always kept
    counts = m.sum(axis=1)
    # kept refs are always the newest ones
    assert (m == (np.arange(3)[None] >= 3 - counts[:, None])).all()
    assert 0.25 < (counts == 3).mean() < 0.35  # p 0.3
    assert 0.25 < (counts == 2).mean() < 0.35  # p 0.3
    assert 0.35 < (counts == 1).mean() < 0.45  # p 0.4


def test_collate_matches_jax_and_batches_cycle():
    ds = SyntheticStoryDataset(5, size=16, num_refs=3, seed=1,
                               vocab_size=64, max_length=8)
    samples = [ds[i] for i in (0, 3)]
    ours, ref = collate(samples), j_collate(samples)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert ours["ref_images"].shape == (3, 2, 16, 16, 3)
    assert ours["ref_input_ids"].shape == (3, 2, 8)
    np.testing.assert_array_equal(ds[3]["image"], samples[1]["image"])
    def batches():
        return iter(DataLoader(ds, 2, seed=0, prefetch=0, num_threads=1))

    it = batches()
    first = [next(it) for _ in range(3)]  # two full batches an epoch
    assert all(b["image"].shape == (2, 16, 16, 3) for b in first)
    again = batches()
    np.testing.assert_array_equal(next(again)["image"], first[0]["image"])
