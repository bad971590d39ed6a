"""The port's native library (storygen_tpu_torch/native), utils/profiling
and utils/util against the JAX package's: the C++ functions bit for bit
against the JAX package's library and the port's numpy forms; the build
into build/, and no quiet fallback when the compiler is missing or
fails; a trace holding an annotated range; StepTimer's statistics."""
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from storygen_tpu import native as jax_native
from storygen_tpu.utils import profiling as jax_profiling
from storygen_tpu.utils import util as jax_util
from storygen_tpu_torch import native
from storygen_tpu_torch.utils import profiling, util

REPO = Path(__file__).resolve().parent.parent


def _frames(seed, n, shape):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("scale,offset", [(1 / 255, 0.0), (2 / 255, -1.0)])
def test_normalize_and_assemble_bit_for_bit(scale, offset):
    frames = _frames(0, 5, (40, 56, 3))
    batch = np.stack(frames)
    out = native.normalize_u8(batch, scale, offset)
    assert out.dtype == np.float32 and out.shape == batch.shape
    np.testing.assert_array_equal(out, native.normalize_u8_numpy(
        batch, scale, offset))
    np.testing.assert_array_equal(out, jax_native.normalize_u8(
        batch, scale, offset))
    got = native.assemble_batch(frames, scale, offset)
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(got, native.assemble_batch_numpy(
        frames, scale, offset))
    np.testing.assert_array_equal(got, jax_native.assemble_batch(
        frames, scale, offset))


@pytest.mark.parametrize("src,dst", [((64, 48, 3), (32, 24)),
                                     ((37, 53, 3), (100, 71)),
                                     ((200, 320, 3), (512, 512)),
                                     ((5, 7, 1), (3, 9))])
def test_resize_bilinear_bit_for_bit(src, dst):
    img = _frames(1, 1, src)[0]
    out = native.resize_bilinear(img, *dst)
    assert out.shape == dst + src[2:] and out.dtype == np.uint8
    np.testing.assert_array_equal(out, native.resize_bilinear_numpy(
        img, *dst))
    np.testing.assert_array_equal(out, jax_native.resize_bilinear(img, *dst))


def test_port_datasets_normalize_through_the_library(monkeypatch):
    from storygen_tpu_torch.data import datasets
    calls = []
    real = native.normalize_u8
    monkeypatch.setattr(native, "normalize_u8",
                        lambda *a: calls.append(a) or real(*a))
    img = _frames(2, 1, (8, 8, 3))[0]
    np.testing.assert_array_equal(datasets.normalize_u8(img, 1 / 255, 0.0),
                                  jax_native.normalize_u8(img, 1 / 255, 0.0))
    assert len(calls) == 1


def test_library_builds_into_build_dir(tmp_path):
    assert native.lib_path().parent.parent == (
        REPO / "build" / "storygen_tpu_torch" / "native")
    assert native.lib_path().parent.name == native.lib_path(
        tmp_path).parent.name
    out = native.build(tmp_path / "build")
    assert out == native.lib_path(tmp_path / "build") and out.exists()
    assert [p.name for p in out.parent.iterdir()] == [native.LIB_NAME]
    assert not list(native.SRC.parent.glob("*.so"))  # none beside the source


def test_no_fallback_without_a_compiler(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build(tmp_path, compiler=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="failed"):
        native.build(tmp_path, compiler="false")
    assert not native.lib_path(tmp_path).exists()
    # the functions raise too: none falls back to its numpy form
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "fresh")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    img = _frames(3, 1, (4, 4, 3))[0]
    for call in (lambda: native.normalize_u8(img, 1.0, 0.0),
                 lambda: native.assemble_batch([img], 1.0, 0.0),
                 lambda: native.resize_bilinear(img, 2, 2)):
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            call()


def test_trace_holds_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port_range_x"):
            torch.ones(64).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(
        files[0].read_text())["traceEvents"]}
    assert "port_range_x" in names


def test_step_timer_stats_equal_jax():
    times = list(np.random.RandomState(4).rand(9))
    port, jax_t = profiling.StepTimer(), jax_profiling.StepTimer()
    port.times, jax_t.times = list(times), list(times)
    for skip in (0, 1, 3):
        assert port.stats(skip) == jax_t.stats(skip)
    with port:
        port.block_on({"a": [torch.ones(2), (torch.zeros(1),)], "b": 3})
    assert len(port.times) == 10 and port.times[-1] >= 0


def test_util_matches_jax():
    def f(a, b=2, **kw):
        return util.get_function_args(), jax_util.get_function_args()

    port, jax_args = f(1, c=3)
    assert port == jax_args == {"a": 1, "b": 2, "c": 3}
    s = util.get_time_string()
    assert len(s) == len(jax_util.get_time_string()) == 15 and s[8] == "T"
    assert inspect.getmodule(util.get_time_string).__name__ == \
        "storygen_tpu_torch.utils.logging"
