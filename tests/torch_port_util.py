"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py):
seeded numpy inputs, JAX params carried into the port's modules through
storygen_tpu_torch/checkpoint/convert.py, and fp32 comparisons."""
import re

import jax
import numpy as np
import torch
from flax.core import unfreeze

from storygen_tpu_torch.checkpoint.convert import jax_to_state_dict

# test_torch_golden.py's fp32 standard
ATOL = 1e-4
RTOL = 1e-4


def rand(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def np_tree(params):
    """A flax variable tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def load(module: torch.nn.Module, params, **convert_kw) -> torch.nn.Module:
    """Carry JAX params into a port module (strict key and shape match)."""
    module.load_state_dict(jax_to_state_dict(np_tree(params), **convert_kw),
                           strict=True)
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def assert_close(jax_out, torch_out, atol: float = ATOL, rtol: float = RTOL,
                 msg: str = ""):
    ref = np.asarray(jax_out, dtype=np.float32)
    got = torch_out.detach().float().numpy() if torch.is_tensor(torch_out) \
        else np.asarray(torch_out, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape, msg)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=msg)


# The tiny serving models of the port's pipeline tests
# (tests/test_torch_port_pipeline.py).
TINY_UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
                 norm_num_groups=4, cross_attention_dim=24)
TINY_VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                norm_num_groups=2)
TINY_CLIP = dict(num_hidden_layers=2, hidden_size=24, intermediate_size=48,
                 num_attention_heads=4)
# A tiny UNet without attention at its first level, for the entry points,
# which render and train at 512 px: attention over the 64 x 64 latent's
# 4096 tokens would take seconds per pass on the CPU
CLI_UNET = dict(block_out_channels=(8, 8, 8, 8), attention_head_dim=2,
                norm_num_groups=2, cross_attention_dim=24, layers_per_block=1,
                down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                  "CrossAttnDownBlock2D", "DownBlock2D"),
                up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                                "CrossAttnUpBlock2D", "UpBlock2D"))


def cli_folder(root: str, tokenizer) -> str:
    """A diffusers folder at `root` of seeded tiny models (CLI_UNET,
    TINY_VAE, TINY_CLIP) with `tokenizer`'s tokenizer/."""
    from storygen_tpu_torch.configs import (CLIPTextConfig, UNetConfig,
                                            VAEConfig)
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    StoryGenPipeline(
        init_random_(UNet2DConditionModel(UNetConfig(**CLI_UNET)), 1),
        init_random_(AutoencoderKL(VAEConfig(**TINY_VAE)), 2),
        init_random_(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), 3),
        tokenizer, device="cpu").save_pretrained(root)
    return root


def jax_params(module, state_dict, convert, *init_args):
    """A port module's weights as the JAX module's variable tree, by the
    JAX package's diffusers import, with the tree's structure taken from
    jax.eval_shape (no JAX init runs)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    return convert({k: v.detach().numpy() for k, v in state_dict.items()},
                   template)


def serving_models(clip: bool = False, seed: int = 1, unet=TINY_UNET):
    """The tiny UNet (TINY_UNET, or the `unet` config's fields) and VAE
    (and CLIP text encoder) in both packages with
    the same weights: the port's seeded random init, taken into JAX trees
    by the JAX package's diffusers import (jax.eval_shape gives the trees'
    structure, so no JAX init runs) and carried back into fresh port
    modules by checkpoint/convert.py (`load`).
    Returns {"unet": (port, jax module, jax params), "vae": ..., "clip":
    ...}, the port's modules on the CPU in eval mode."""
    import jax.numpy as jnp

    from storygen_tpu.checkpoint import hf_import
    from storygen_tpu.configs import CLIPTextConfig as JCLIPConfig
    from storygen_tpu.configs import UNetConfig as JUNetConfig
    from storygen_tpu.configs import VAEConfig as JVAEConfig
    from storygen_tpu.models.clip_text import CLIPTextModel as JCLIP
    from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
    from storygen_tpu.models.vae import AutoencoderKL as JVAE
    from storygen_tpu_torch.checkpoint.convert import (CLIP_REWRITES,
                                                       VAE_REWRITES)
    from storygen_tpu_torch.configs import (CLIPTextConfig, UNetConfig,
                                            VAEConfig)
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL

    def both(port_cls, cfg, jax_mod, seed, convert, init_args, **convert_kw):
        params = jax_params(jax_mod, init_random_(port_cls(cfg), seed)
                            .state_dict(), convert, *init_args)
        return load(port_cls(cfg), params, **convert_kw), jax_mod, params

    out = {
        "unet": both(UNet2DConditionModel, UNetConfig(**unet),
                     JUNet(config=JUNetConfig(**unet)), seed,
                     hf_import.torch_to_flax_unet,
                     (jnp.zeros((1, 8, 8, 4)), jnp.asarray([0]),
                      jnp.zeros((1, 7, unet["cross_attention_dim"])))),
        "vae": both(AutoencoderKL, VAEConfig(**TINY_VAE),
                    JVAE(config=JVAEConfig(**TINY_VAE)), seed + 1,
                    hf_import.torch_to_flax_vae,
                    (jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(0)),
                    key_rewrites=VAE_REWRITES)}
    if clip:
        out["clip"] = both(CLIPTextModel, CLIPTextConfig(**TINY_CLIP),
                           JCLIP(config=JCLIPConfig(**TINY_CLIP)), seed + 2,
                           hf_import.torch_to_flax_clip,
                           (jnp.zeros((1, 77), jnp.int32),),
                           prefix="text_model.", key_rewrites=CLIP_REWRITES)
    return out


def tokenizer(prompts):
    """Token ids seeded by each prompt's length, shared by both packages."""
    return np.stack([np.random.RandomState(len(p)).randint(0, 49408, 77)
                     for p in prompts])


def jax_frame_draws(key):
    """The draws that the JAX package's _generate(rng=key) makes, as the
    port's draw(name, shape): the five keys of jax.random.split(key, 5)
    are the port's DRAWS in order; "step" row i is normal(fold_in(k_eta,
    i))."""
    import jax.numpy as jnp

    from storygen_tpu_torch.pipeline import DRAWS
    keys = dict(zip(DRAWS, jax.random.split(key, 5)))

    def draw(name, shape):
        if name == "step":
            z = jnp.stack([jax.random.normal(
                jax.random.fold_in(keys["step"], i), shape[1:], jnp.float32)
                for i in range(shape[0])])
        else:
            z = jax.random.normal(keys[name], shape, jnp.float32)
        return t(z)
    return draw


def jax_story_draws(rng, num_prompts: int):
    """The draws of the JAX package's stories on base key `rng`, as the
    port's draw(frame, name, shape): frame k's from fold_in(rng, k), and
    the reuse_latents first-frame encode's (frame num_prompts) from
    fold_in(rng, num_prompts) itself."""
    def draw(frame, name, shape):
        key = jax.random.fold_in(rng, frame)
        if frame == num_prompts:
            assert name == "ref_posterior", name
            return t(jax.random.normal(key, shape))
        return jax_frame_draws(key)(name, shape)
    return draw


def sample_both(models, *, sampler, stage, steps, eta=0.0, rfi=1,
                num_refs=2, b=1, hw=16, txt=7, seed=0):
    """StoryGenSampler.sample of the JAX package and of the port on the
    same inputs (seeded numpy; the per-step noise of eta > 0 and euler_a
    as the JAX sampler draws it from sample_rng); returns both final
    latents."""
    import jax.numpy as jnp

    from storygen_tpu.pipeline import StoryGenSampler as JSampler
    from storygen_tpu_torch.pipeline import StoryGenSampler, timesteps
    from storygen_tpu_torch.configs import SchedulerConfig
    unet, junet, up = models["unet"]
    d = TINY_UNET["cross_attention_dim"]
    lat = (b, hw, hw, 4)
    inputs = [rand(seed, lat), rand(seed + 1, (b, txt, d)),
              rand(seed + 2, (b, txt, d))]
    if stage == "no":
        inputs += [None] * 4
    else:
        inputs += [rand(seed + 3, (num_refs,) + lat, 0.5),
                   rand(seed + 4, lat, 0.05),
                   rand(seed + 5, (num_refs, b, txt, d)),
                   rand(seed + 6, (num_refs, b, txt, d))]
    inputs.append(rand(seed + 7, lat))
    key = jax.random.PRNGKey(seed)
    kw = dict(stage=stage, num_inference_steps=steps, sampler=sampler,
              eta=eta, ref_feature_interval=rfi)
    js = JSampler(junet, None)
    out_j = js.sample({"unet": up, "vae": None},
                      *[None if x is None else jnp.asarray(x)
                        for x in inputs],
                      jnp.asarray(7.5), jnp.asarray(3.5), sample_rng=key,
                      **kw)
    n_iters = len(timesteps(SchedulerConfig(), sampler, steps).t)
    step_noise = torch.stack([t(jax.random.normal(
        jax.random.fold_in(key, i), lat)) for i in range(n_iters)])
    ts = StoryGenSampler(unet, models["vae"][0], device="cpu")
    out_t = ts.sample(*[None if x is None else t(x) for x in inputs], 7.5,
                      3.5, step_noise=step_noise, **kw)
    return out_j, out_t


class View:
    """A (B, S, H*D) operand's shape and element strides, as a tensor
    gives them (contiguous unless `strides` is given): what the flash
    kernels' tensor-map plans (ops/flash_attention.py::operand_map) read."""

    def __init__(self, shape, strides=None):
        self.shape = tuple(shape)
        b, s, hd = shape
        self._strides = tuple(strides or (s * hd, hd, 1))

    def stride(self, dim=None):
        return self._strides if dim is None else self._strides[dim]


def c_expr(expr: str) -> str:
    """An integer expression of the kernels' CUDA sources as Python: `/`
    divides integers (every operand here is >= 0), `c ? x : y` is a
    conditional, `&&`, `||` and `!` the logical operators; the `a.` and
    `C::` prefixes, casts and `reinterpret_cast<T>` drop out and
    `sizeof(float)` is 4."""
    e = re.sub(r"//[^\n]*", "", expr)
    e = re.sub(r"\b(?:a\.|C::)", "", e)
    e = re.sub(r"reinterpret_cast<\w+>", "", e)
    e = re.sub(r"\((?:cuuint(?:32|64)_t|long long|int|unsigned)\)", "", e)
    e = e.replace("sizeof(float)", "4")
    e = e.replace("true", "1").replace("false", "0")
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"!(?!=)", " not ", e)
    return _c_conditional(e)


def _c_conditional(e: str) -> str:
    if "?" in e:
        cond, rest = e.split("?", 1)
        yes, no = rest.split(":", 1)
        return (f"(({_c_conditional(yes)}) if ({_c_conditional(cond)}) "
                f"else ({_c_conditional(no)}))")
    return " ".join(re.sub(r"/", "//", e).split())


def c_eval(expr: str, **names) -> int:
    """The value of a CUDA source's integer expression (c_expr) with
    `names` bound (bools as 0 / 1)."""
    return eval(c_expr(expr), {"__builtins__": {}, "min": min, "max": max},
                dict(names))


def cuda_struct(src: str, name: str, **params):
    """The `static constexpr int` members of the template struct `name` in
    the CUDA source `src`, evaluated in order as the compiler would with
    the template parameters `params`, and the messages of its
    `static_assert`s that fail there: (members, failed)."""
    body = re.search(r"struct %s \{(.*?)\n\};" % re.escape(name), src,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    env = dict(params)
    for decl in re.findall(r"static constexpr int (.*?);", body, re.S):
        for item in re.split(r",(?![^(]*\))", decl):
            key, expr = item.split("=", 1)
            env[key.strip()] = c_eval(expr, **env)
    failed = [msg for cond, msg in re.findall(
        r'static_assert\((.*?),\s*"([^"]*)"\);', body, re.S)
        if not c_eval(cond, **env)]
    return {k: v for k, v in env.items() if k not in params}, failed
