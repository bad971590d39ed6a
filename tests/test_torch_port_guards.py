"""Guards of the port that need no GPU: it never imports JAX or Flax, its
build names sm_90a and a build/ output, and its kernel modules call no
library kernel in place of their own."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from storygen_tpu_torch.ops import _build

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib)\b", re.M)
    for p in PORT.rglob("*.py"):
        assert not pat.search(p.read_text()), p
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not pat.search(smoke)
    assert not re.search(r"\bstorygen_tpu\.(?!configs\b)", smoke)


def test_nvcc_command_targets_sm90a_into_build_dir():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"flash_fwd.cu", "geglu_matmul.cu",
                                      "conv3x3.cu"}
    out = _build.lib_path(srcs)
    cmd = _build.nvcc_command("/usr/local/cuda/bin/nvcc", srcs, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert {"-O3", "-shared", "-Xcompiler", "-fPIC"} <= set(cmd)
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert out.parent.parent == REPO / "build" / "storygen_tpu_torch"
    assert all(str(s) in cmd for s in srcs)
    # the hash keys the build on the sources
    assert len(out.parent.name) == 16
    assert _build.source_hash(srcs) == out.parent.name


@pytest.mark.parametrize("name", ["flash_attention.py", "geglu.py",
                                  "conv.py", "_build.py"])
def test_kernel_modules_call_no_library_kernel(name):
    src = (PORT / "ops" / name).read_text()
    for banned in ("scaled_dot_product_attention", "torch.compile",
                   "cpp_extension", "flash_attn", "xformers", "triton.ops",
                   "cudnn"):
        assert banned not in src, (name, banned)
