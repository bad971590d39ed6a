"""Guards of the port that need no GPU: it never imports JAX, Flax or the
JAX package, its build names sm_90a and a build/ output, its kernel
modules call no library kernel in place of their own, and its entry points
(training and serving) refuse to run without a card unless the caller asks
for the CPU, and never move models behind the caller's back."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from storygen_tpu_torch.configs import (CLIPTextConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.models.clip_text import CLIPTextModel
from storygen_tpu_torch.models.unet import UNet2DConditionModel
from storygen_tpu_torch.models.vae import AutoencoderKL
from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.pipeline import StoryGenPipeline, StoryGenSampler
from storygen_tpu_torch.training import trainer

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "storygen_tpu_torch"


def test_port_imports_no_jax_or_flax():
    code = (
        "import sys\n"
        "import storygen_tpu_torch.pipeline, storygen_tpu_torch.models.unet\n"
        "import storygen_tpu_torch.models.vae, "
        "storygen_tpu_torch.models.clip_text\n"
        "import storygen_tpu_torch.models.init, "
        "storygen_tpu_torch.checkpoint.convert\n"
        "import storygen_tpu_torch.ops.attention, "
        "storygen_tpu_torch.ops.conv, storygen_tpu_torch.ops.geglu\n"
        "import storygen_tpu_torch.ops.downconv, "
        "storygen_tpu_torch.utils.device\n"
        "import storygen_tpu_torch.configs, storygen_tpu_torch.data.loader\n"
        "import storygen_tpu_torch.training.losses, "
        "storygen_tpu_torch.training.optim\n"
        "import storygen_tpu_torch.training.steps, "
        "storygen_tpu_torch.training.trainer\n"
        "import storygen_tpu_torch.utils.logging\n"
        "import storygen_tpu_torch.ops.study_attention, "
        "storygen_tpu_torch.ops.study_int8\n"
        "import storygen_tpu_torch.studies.common, "
        "storygen_tpu_torch.studies.bench_attn_variants\n"
        "import storygen_tpu_torch.studies.bench_attn_v2, "
        "storygen_tpu_torch.studies.bench_attn_scan\n"
        "import storygen_tpu_torch.studies.bench_attn_ablate, "
        "storygen_tpu_torch.studies.bench_attn_bnd2\n"
        "import storygen_tpu_torch.studies.bench_attn_multihead, "
        "storygen_tpu_torch.studies.bench_attn_int8\n"
        "import storygen_tpu_torch.studies.bench_attn_int8_epilogue\n"
        "import storygen_tpu_torch.studies.conv_tiles, "
        "storygen_tpu_torch.studies.flash_fwd_tiles\n"
        "import storygen_tpu_torch.studies.flash_bwd_tiles, "
        "storygen_tpu_torch.studies.geglu_tiles\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'storygen_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|jaxlib|storygen_tpu)(\.|\s|$)",
        re.M)
    for p in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pat.search(p.read_text()), p


def test_nvcc_command_targets_sm90a_into_build_dir():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"flash_fwd.cu", "flash_bwd.cu",
                                      "geglu_matmul.cu", "conv3x3.cu",
                                      "downconv3x3.cu", "study_online.cu",
                                      "study_bounded.cu", "study_qk.cu",
                                      "study_int8.cu"}
    assert {p.name for p in _build.headers()} == {"study_mma.cuh",
                                                  "conv_mma.cuh"}
    out = _build.lib_path(srcs)
    nvcc = "/usr/local/cuda/bin/nvcc"
    for src in srcs:
        obj = out.with_name(src.stem + ".o")
        cmd = _build.compile_command(nvcc, src, obj)
        assert cmd[cmd.index("-gencode") + 1] == \
            "arch=compute_90a,code=sm_90a"
        assert {"-O3", "-c", "-Xcompiler", "-fPIC"} <= set(cmd)
        assert cmd[cmd.index("-o") + 1] == str(obj) and cmd[-1] == str(src)
    objs = [out.with_name(s.stem + ".o") for s in srcs]
    link = _build.link_command(nvcc, objs, out)
    assert "-shared" in link and link[link.index("-o") + 1] == str(out)
    assert all(str(o) in link for o in objs)
    assert out.parent.parent == REPO / "build" / "storygen_tpu_torch"
    # the hash keys the build on the sources
    assert len(out.parent.name) == 16
    assert _build.source_hash(srcs) == out.parent.name


def test_source_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Editing a header that the sources include changes the build's hash,
    so the library is rebuilt."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.sources() + _build.headers():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    srcs = _build.sources()
    before = _build.source_hash(srcs)
    header = csrc / "study_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_hash(srcs) != before


@pytest.mark.parametrize("name", [
    "flash_attention.py", "geglu.py", "conv.py", "_build.py", "attention.py",
    "downconv.py", "study_attention.py", "study_int8.py", "flash_fwd.cu",
    "flash_bwd.cu", "geglu_matmul.cu", "conv3x3.cu", "downconv3x3.cu",
    "study_online.cu", "study_bounded.cu", "study_qk.cu", "study_int8.cu",
    "study_mma.cuh", "conv_mma.cuh"])
def test_kernel_modules_call_no_library_kernel(name):
    src = (PORT / ("ops" if name.endswith(".py") else "csrc") / name
           ).read_text()
    for banned in ("scaled_dot_product_attention", "torch.compile",
                   "cpp_extension", "flash_attn", "xformers", "triton.ops",
                   "cudnn", "cublas", "cutlass"):
        assert banned not in src.lower(), (name, banned)


def test_sdpa_only_as_the_studies_yardstick():
    """PyTorch's fused attention appears in the port only in
    studies/common.py, where it is timed beside the kernels (and in
    chip_smoke.py, outside the package)."""
    users = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
             if "scaled_dot_product_attention" in p.read_text()}
    assert users == {"studies/common.py"}


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(logdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.build_models(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train("stage2", cfg, dataset=[])
    assert trainer.resolve_device("cpu") == torch.device("cpu")
    # serving: the models are built on the CPU, as nn.Modules are by default
    unet, vae, clip = _tiny_serving_models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoryGenPipeline(unet, vae, clip, lambda p: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoryGenSampler(unet, vae)
    pipe = StoryGenPipeline(unet, vae, clip, lambda p: None, device="cpu")
    assert pipe.device == pipe.sampler.device == torch.device("cpu")


def test_entry_points_refuse_models_elsewhere():
    """A model that is not on the device asked for raises; it is not
    moved."""
    unet, vae, clip = _tiny_serving_models()
    with torch.device("meta"):
        meta_vae = type(vae)(vae.config)
    with pytest.raises(ValueError, match="vae has parameters on"):
        StoryGenPipeline(unet, meta_vae, clip, lambda p: None, device="cpu")
    with pytest.raises(ValueError, match="vae has parameters on"):
        StoryGenSampler(unet, meta_vae, device="cpu")
    assert next(meta_vae.parameters()).is_meta


def _tiny_serving_models():
    unet = UNet2DConditionModel(UNetConfig(
        block_out_channels=(8, 8, 8, 8), attention_head_dim=2,
        norm_num_groups=2, cross_attention_dim=8))
    vae = AutoencoderKL(VAEConfig(block_out_channels=(4, 4, 4, 4),
                                  layers_per_block=1, norm_num_groups=2))
    clip = CLIPTextModel(CLIPTextConfig(
        num_hidden_layers=1, hidden_size=8, intermediate_size=16,
        num_attention_heads=2))
    return unet, vae, clip
