"""Port parity: checkpoint folders between the two packages.

A folder that the JAX package's exporter writes loads into the port's
modules (checkpoint/hf_import.py), and a folder that the port writes
(StoryGenPipeline.save_pretrained over checkpoint/hf_export.py) loads into
the JAX package; both compute what the JAX modules compute on the same
inputs (the UNet in both cycles, the VAE encode and decode, the CLIP text
encoder; fp32, 1e-4). The weights are the port's seeded init carried into
JAX trees (tests/torch_port_util.py::serving_models). The JAX loader's
templates come from `jax.eval_shape` of each module's init (its key
mapping, surgery and shape checks run as they are), which skips about a
minute of JAX initialisation. Also: the config.json schemas, the
attn3/norm4 surgery, the SD-1.5 key manifests, the safetensors reader and
the loader's errors.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.checkpoint import hf_export as j_export
from storygen_tpu.checkpoint import hf_import as j_import
from storygen_tpu.configs import CLIPTextConfig as JCLIPConfig
from storygen_tpu.configs import SchedulerConfig as JSchedulerConfig
from storygen_tpu.configs import UNetConfig as JUNetConfig
from storygen_tpu.configs import VAEConfig as JVAEConfig
from storygen_tpu.configs import load_pretrained_configs as j_configs
from storygen_tpu.models.clip_text import CLIPTextModel as JCLIP
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu_torch.checkpoint import hf_export, hf_import
from storygen_tpu_torch.configs import (CLIPTextConfig, UNetConfig,
                                        VAEConfig, load_pretrained_configs)
from storygen_tpu_torch.models.clip_text import CLIPTextModel
from storygen_tpu_torch.models.init import init_random_
from storygen_tpu_torch.models.unet import UNet2DConditionModel
from storygen_tpu_torch.models.vae import AutoencoderKL
from storygen_tpu_torch.pipeline import StoryGenPipeline
from tests.torch_port_util import (TINY_CLIP, TINY_UNET, TINY_VAE,
                                   assert_close, rand, serving_models, t,
                                   tokenizer)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
HW, TXT = 8, 7
D = TINY_UNET["cross_attention_dim"]


class SavingTokenizer:
    """The tests' tokenizer with a save_pretrained of its own."""

    def __call__(self, prompts):
        return tokenizer(prompts)

    def save_pretrained(self, path):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump({}, f)


def _shapes_only(init):
    """A module init that returns zeros of the init's shapes."""
    def fake(self, *args, **kw):
        s = jax.eval_shape(functools.partial(init, self), *args, **kw)
        return jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                      s)
    return fake


@pytest.fixture
def fast_jax_templates(monkeypatch):
    for cls in (JUNet, JVAE, JCLIP):
        monkeypatch.setattr(cls, "init", _shapes_only(cls.init))


@pytest.fixture(scope="module")
def models():
    """The port's modules, the JAX modules and params with the same
    weights, the inputs, and the JAX outputs as a function of the params
    (jitted once per call shape)."""
    m = serving_models(clip=True)
    (unet, junet, up), (vae, jvae, vp), (clip, jclip, cp) = (
        m["unet"], m["vae"], m["clip"])
    inputs = dict(
        refs=rand(0, (2, HW, HW, 4)), rtext=rand(1, (2, TXT, D)),
        x=rand(2, (1, HW, HW, 4)), text=rand(3, (1, TXT, D)),
        image=rand(4, (1, 64, 64, 3), 0.5), z=rand(5, (1, HW, HW, 4)),
        ids=np.random.RandomState(6).randint(0, 49408, (2, 77)))

    @jax.jit
    def jax_outputs(up, vp, cp):
        i = {k: jnp.asarray(v) for k, v in inputs.items()}
        eps_ref, raw = junet.apply(up, i["refs"], jnp.asarray([45, 45]),
                                   i["rtext"])
        ctx = {k: jnp.concatenate([v[0:1], v[1:2]], axis=1)
               for k, v in raw.items()}
        eps, _ = junet.apply(up, i["x"], jnp.asarray([501]), i["text"], ctx)
        dist = jvae.apply(vp, i["image"], method=jvae.encode)
        dec = jvae.apply(vp, i["z"], method=jvae.decode)
        emb = jclip.apply(cp, i["ids"])
        return dict(eps_ref=eps_ref, ctx=raw, eps=eps, mean=dist.mean,
                    logvar=dist.logvar, dec=dec, emb=emb)

    return dict(unet=unet, vae=vae, clip=clip, up=up, vp=vp, cp=cp,
                inputs=inputs, jax_outputs=jax_outputs)


def _port_outputs(unet, vae, clip, inputs):
    i = {k: t(v) for k, v in inputs.items() if k != "ids"}
    with torch.no_grad():
        eps_ref, raw = unet(i["refs"], torch.tensor([45, 45]), i["rtext"])
        ctx = {k: torch.cat([v[0:1], v[1:2]], dim=1) for k, v in raw.items()}
        eps, _ = unet(i["x"], torch.tensor([501]), i["text"], ctx)
        dist = vae.encode(i["image"])
        return dict(eps_ref=eps_ref, ctx=raw, eps=eps, mean=dist.mean,
                    logvar=dist.logvar, dec=vae.decode(i["z"]),
                    emb=clip(torch.from_numpy(inputs["ids"])))


def _assert_outputs_close(ref, got, msg):
    assert set(ref) == set(got)
    for k in ref:
        if k == "ctx":
            assert set(ref[k]) == set(got[k])
            for c in ref[k]:
                assert_close(ref[k][c], got[k][c], msg=f"{msg} ctx {c}")
        else:
            assert_close(ref[k], got[k], msg=f"{msg} {k}")


def _jax_configs():
    return {"unet": JUNetConfig(**TINY_UNET), "vae": JVAEConfig(**TINY_VAE),
            "clip": JCLIPConfig(**TINY_CLIP)}


def test_jax_folder_loads_in_the_port(models, tmp_path):
    root = str(tmp_path / "jax")
    j_export.save_pretrained(root, unet_params=models["up"],
                             vae_params=models["vp"],
                             clip_params=models["cp"],
                             configs=_jax_configs())
    # both packages read the folder's configs alike
    for mine, theirs in zip(load_pretrained_configs(root), j_configs(root)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    b = hf_import.load_diffusers_pretrained(root, device="cpu")
    assert b["unet_config"] == UNetConfig(**TINY_UNET)
    assert b["clip_config"] == CLIPTextConfig(**TINY_CLIP)
    for m in (b["unet"], b["vae"], b["text_encoder"]):
        assert all(p.dtype == torch.float32 and p.device.type == "cpu"
                   for p in m.parameters())
    ref = models["jax_outputs"](models["up"], models["vp"], models["cp"])
    got = _port_outputs(b["unet"], b["vae"], b["text_encoder"],
                        models["inputs"])
    _assert_outputs_close(ref, got, "JAX folder in the port")


def test_port_folder_loads_in_jax(models, tmp_path, fast_jax_templates):
    root = str(tmp_path / "port")
    pipe = StoryGenPipeline(models["unet"], models["vae"], models["clip"],
                            SavingTokenizer(), device="cpu")
    pipe.save_pretrained(root)
    assert os.path.isfile(os.path.join(root, "tokenizer", "vocab.json"))
    assert os.path.isfile(os.path.join(root, "unet",
                                       "diffusion_pytorch_model.bin"))
    assert os.path.isfile(os.path.join(root, "text_encoder",
                                       "pytorch_model.bin"))
    # every config.json is the JAX exporter's schema for the same configs
    jc = _jax_configs()
    for sub, fname, payload in (
            ("unet", "config.json",
             j_export.diffusers_unet_config(jc["unet"])),
            ("vae", "config.json", j_export.diffusers_vae_config(jc["vae"])),
            ("text_encoder", "config.json",
             j_export.transformers_clip_config(jc["clip"])),
            ("scheduler", "scheduler_config.json",
             j_export.diffusers_scheduler_config(JSchedulerConfig())),
            ("", "model_index.json", j_export.MODEL_INDEX)):
        with open(os.path.join(root, sub, fname)) as f:
            assert json.load(f) == json.loads(json.dumps(payload)), sub
    jb = j_import.load_diffusers_pretrained(root)
    ref = models["jax_outputs"](jb["unet_params"], jb["vae_params"],
                                jb["text_params"])
    got = _port_outputs(models["unet"], models["vae"], models["clip"],
                        models["inputs"])
    _assert_outputs_close(ref, got, "port folder in JAX")


def test_bf16_folder_round_trips_bit_for_bit(tmp_path):
    """bf16 weights stay bf16 in the .bin files and come back equal, the
    text encoder also from a CLIP/ folder."""
    mods = dict(
        unet=init_random_(UNet2DConditionModel(UNetConfig(**TINY_UNET)), 1),
        vae=init_random_(AutoencoderKL(VAEConfig(**TINY_VAE)), 2),
        text_encoder=init_random_(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)),
                                  3))
    mods = {k: v.to(torch.bfloat16) for k, v in mods.items()}
    hf_export.save_pretrained(str(tmp_path), **mods)
    sd = torch.load(tmp_path / "unet" / "diffusion_pytorch_model.bin",
                    weights_only=True)
    assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    # the reference checkpoint's layout: the text encoder under CLIP/
    os.rename(tmp_path / "text_encoder", tmp_path / "CLIP")
    b = hf_import.load_diffusers_pretrained(str(tmp_path), device="cpu",
                                            dtype=torch.bfloat16)
    for k, m in mods.items():
        got = b[k].state_dict()
        for name, v in m.state_dict().items():
            assert got[name].dtype == torch.bfloat16
            assert torch.equal(got[name], v), (k, name)


def test_attn3_surgery_matches_jax():
    unet = init_random_(UNet2DConditionModel(UNetConfig(**TINY_UNET)), 4)
    full = unet.state_dict()
    vanilla = {k: v for k, v in full.items()
               if ".attn3." not in k and ".norm4." not in k}
    assert len(full) - len(vanilla) == 16 * 7  # 5 attn3 + 2 norm4 tensors
    got = hf_import.apply_attn3_surgery(vanilla)
    ref = j_import.apply_attn3_surgery(
        {k: v.numpy() for k, v in vanilla.items()})
    assert set(got) == set(ref) == set(full)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the copies are tensors of their own: training attn3 leaves attn1
    k1 = next(k for k in vanilla if ".attn1.to_q." in k)
    k3 = k1.replace(".attn1.", ".attn3.")
    assert got[k3].data_ptr() != got[k1].data_ptr()
    # a vanilla file loads with attn3 = attn1 and norm4 = norm1
    with torch.device("meta"):
        meta = UNet2DConditionModel(UNetConfig(**TINY_UNET))
    loaded = hf_import.load_into(meta, got, torch.device("cpu"),
                                 torch.float32).state_dict()
    for k, v in loaded.items():
        src = k.replace(".attn3.", ".attn1.").replace(".norm4.", ".norm1.")
        assert torch.equal(v, full[src]), k


@pytest.mark.parametrize("cls,cfg,manifest", [
    (UNet2DConditionModel, UNetConfig, "sd15_storygen_unet_keys.txt"),
    (AutoencoderKL, VAEConfig, "sd15_vae_keys.txt"),
    (CLIPTextModel, CLIPTextConfig, "sd15_clip_text_keys.txt")],
    ids=["unet", "vae", "clip"])
def test_full_width_keys_match_the_sd15_manifests(cls, cfg, manifest):
    with torch.device("meta"):
        module = cls(cfg())
    with open(os.path.join(FIXTURES, manifest)) as f:
        want = sorted(line.strip() for line in f if line.strip())
    assert sorted(module.state_dict()) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": torch.randn((5, 3), generator=g),
        "b": torch.randn((7,), generator=g) * 100,
        "scalar": torch.randn((), generator=g),
        "empty": torch.zeros((0, 4)),
    }
    tensors = {k: v.to(dtype) for k, v in tensors.items()}
    tensors["a_byte"] = torch.tensor([7], dtype=torch.uint8)
    path = str(tmp_path / "w.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    from safetensors.torch import load_file
    ref = load_file(path)
    got = hf_import.load_state_dict_file(path)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_loader_errors_and_extra_keys(tmp_path):
    cfg = CLIPTextConfig(**TINY_CLIP)
    sd = init_random_(CLIPTextModel(cfg), 5).state_dict()

    def load(state):
        with torch.device("meta"):
            m = CLIPTextModel(cfg)
        return hf_import.load_into(m, state, torch.device("cpu"),
                                   torch.float32)

    missing = dict(sd)
    del missing["text_model.final_layer_norm.weight"]
    with pytest.raises(KeyError, match="final_layer_norm.weight"):
        load(missing)
    wrong = dict(sd)
    wrong["text_model.final_layer_norm.bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch at "
                       "text_model.final_layer_norm.bias"):
        load(wrong)
    # older transformers checkpoints carry position_ids: ignored
    extra = dict(sd, **{"text_model.embeddings.position_ids":
                        torch.arange(77)[None]})
    m = load(extra)
    assert all(torch.equal(m.state_dict()[k], v) for k, v in sd.items())
    # a folder with no weight file
    os.makedirs(tmp_path / "unet")
    with pytest.raises(FileNotFoundError):
        hf_import.find_weight_file(str(tmp_path / "unet"))
