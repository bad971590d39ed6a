"""The harness's arithmetic and discovery on the CPU: the busy union and
idle gaps of a trace, the kernel classifier on kernel names recorded on
the card, the metric readers, and a configuration, traffic mix, cell and
metric dropped in as new files."""
import json
import shutil
from pathlib import Path

import pytest

from benchmark import counts, readers, trace
from benchmark.core import Bench, kind_class

ROOT = Path(__file__).resolve().parents[2]

# kernel names as torch.profiler recorded them on an NVIDIA H100 80GB HBM3
RECORDED = {
    "void sg_flash::flash_wg_kernel<48, 3, 128, 2, 64, false, false, false>"
    "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, sg_flash::FwArgs)":
        "F / M",
    "void sg_flash::lse_wg_kernel<48, 2, 128, 3, 64, true>(CUtensorMap_st)":
        "L",
    "void sg_flash::flash_bwd_wg_kernel<64, 1, false>(CUtensorMap_st)":
        "DQ / DKV",
    "void sg_geglu::geglu_wg_kernel<128, 256, 64, 4>(CUtensorMap_st)": "G",
    "void sg_conv::wg_conv_kernel<1, 0, 6, 32, 1, 3, 1, 160, 32, 2>"
    "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, sg_conv::Args)": "C",
    "void sg_conv::wg_conv_kernel<1, 1, 6, 32, 1, 3, 1, 128, 32, 2>(x)": "P",
    "void sg_conv::wg_conv_kernel<2, 0, 6, 32, 1, 3, 1, 128, 32, 2>(x)": "D",
    "void sg_conv::wg_conv_kernel<1, 2, 8, 16, 1, 2, 1, 128, 32, 2>(x)": "U",
    "void sg_conv::wg_conv_kernel<2, 3, 8, 16, 1, 2, 1, 128, 32, 2>(x)":
        "UB",
    "void sg_conv::wg_splitk_reduce<2, 3>(float const*, int)": "UB",
    "void sg_conv::conv_mma_kernel<4, 320>(x)": "C",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
    "_nocast<at::native::CUDAFunctor_add<float> >(at::TensorIteratorBase&)"
    ">": "plain torch",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize"
    "2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas": "plain torch",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize64x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn": "plain torch",
}
LIBRARY_CONVS = [
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize64x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
    "5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize64x128x64_warpgroupsize1x1x1_g1_strided_execute_kernel__"
    "5x_cudnn"]


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_the_classifier_on_recorded_names(name):
    assert trace.port_kernel(name) == RECORDED[name]


@pytest.mark.parametrize("name", sorted(RECORDED) + LIBRARY_CONVS)
def test_library_convs_are_told_apart(name):
    assert trace.library_conv(name) == (name in LIBRARY_CONVS)


def test_busy_union_and_idle_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 6.5)]
    assert trace.union_seconds(spans) == pytest.approx(3.5)
    assert trace.gaps(spans, 0.0, 7.0) == [(2.0, 3.0), (4.0, 6.0),
                                           (6.5, 7.0)]
    assert trace.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_gaps_are_named_by_the_host_op_running_through_them():
    idle = [(2.0, 3.0), (4.0, 6.0), (7.0, 7.5)]
    host = [(1.5, 3.5, "aten::linear"), (3.6, 5.2, "aten::to"),
            (5.3, 5.4, "aten::add")]
    assert trace.name_gaps(idle, host) == [
        ["aten::to", 2.0], ["aten::linear", 1.0],
        ["python between ops", 0.5]]


def test_reduce_events():
    dev = [(0.0, 1.0, "void sg_conv::wg_conv_kernel<1, 0, 6>(x)"),
           (1.0, 1.5, "elementwise_kernel"),
           (2.0, 2.5, LIBRARY_CONVS[0])]
    s = trace.reduce_events(dev, [], window_s=4.0)
    assert s["busy_s"] == pytest.approx(2.0)
    assert s["by_port"] == pytest.approx({"C": 1.0, "plain torch": 1.0})
    assert s["library_conv_s"] == pytest.approx(0.5)
    assert s["idle_gaps"] == [["python between ops", pytest.approx(0.5)]]
    assert s["device_ops"][0][1] == 1.0


def run_dict(**kw):
    run = {"job": "serve", "units": 8, "window_s": 4.0, "setup_s": 9.0,
           "peak_bytes": 2 ** 31, "vae_ms": 12.0, "window_flops": 989e12,
           "flops_s": 2.0, "profiled_ops": [
               counts.Op("attn", 989e9, 0.0), counts.Op("conv", 0.0, 0.0,
                                                        0.0)],
           "trace": {"device_s": 2.0, "busy_s": 1.5, "window_s": 3.0,
                     "by_port": {"F / M": 4e-3, "plain torch": 1.0,
                                 "C": 0.5},
                     "library_conv_s": 0.0}}
    run.update(kw)
    return run


def test_the_readers():
    run = run_dict()
    assert readers.rate(run, "serve") == 2.0
    assert readers.rate(run, "train") is None
    assert readers.plain_share(run, "serve") == pytest.approx(50.0)
    assert readers.idle_share(run, "serve") == pytest.approx(50.0)
    assert readers.roofline(run, "serve", "attn") == pytest.approx(25.0)
    assert readers.mfu(run, "serve") == pytest.approx(50.0)
    assert readers.peak_gib(run, "serve") == 2.0


def test_a_reader_without_its_work_returns_nothing():
    """No kernel of the class in the trace, or no op of it counted: no
    number, never 0."""
    run = run_dict()
    run["trace"]["by_port"] = {"plain torch": 1.0}
    assert readers.roofline(run, "serve", "attn") is None
    assert readers.roofline(run_dict(profiled_ops=[]), "serve", "attn") \
        is None
    assert readers.plain_share(run_dict(trace=None), "serve") is None


def test_every_metric_of_benchmark_json_has_a_reader():
    bench = Bench()
    for group in ("end_to_end", "per_layer"):
        for m in bench.spec[group]:
            assert callable(bench.reader(m["name"])), m["name"]


def test_every_cell_finds_its_files():
    bench = Bench()
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        assert kind_class(bench.traffic(w["traffic"])["kind"])
        assert bench.limits(w["name"]), w["name"]
        assert any(m["name"] == "setup_s"
                   for m in bench.metrics(w["name"], per_layer=False))
        assert bench.metrics(w["name"], per_layer=True)


def test_new_files_add_a_configuration_a_mix_a_cell_and_a_metric(tmp_path):
    """Adding files and entries, editing none, makes a new cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "results"))
    here = tmp_path / "benchmark"
    cfg = json.loads((here / "configs" / "sd15-vlcm-story-infer.json")
                     .read_text())
    cfg["name"] = "sd15-vlcm-story-infer-768"
    cfg["sampling"].update(height=768, width=768)
    (here / "configs" / "sd15-vlcm-story-infer-768.json").write_text(
        json.dumps(cfg))
    (here / "traffic" / "story_frame_2ref_b2.json").write_text(json.dumps(
        {"kind": "story_frame", "batch": 2, "refs": 2,
         "caption_tokens": [5, 40]}))
    (here / "workloads" / "story-768-2ref-b2.json").write_text(json.dumps(
        {"limits": {"latent_rel": 0.1, "image_rel": 0.1}}))
    (here / "metrics" / "frames_per_call.serve.py").write_text(
        "def read(run):\n    return run['units'] / 2.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cfg["name"], "source": "x",
                            "file": "benchmark/configs/"
                                    "sd15-vlcm-story-infer-768.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "story-768-2ref-b2",
                              "config": cfg["name"],
                              "traffic": "story_frame_2ref_b2", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "frames_per_call.serve", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "pipeline", "moves": "frames_per_s",
                              "workloads": ["story-768-2ref-b2"]})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("story-768-2ref-b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path)
    assert bench.config("sd15-vlcm-story-infer-768")["sampling"][
        "height"] == 768
    kind = kind_class(bench.traffic("story_frame_2ref_b2")["kind"])
    assert kind.__name__ == "StoryFrame"
    assert bench.limits("story-768-2ref-b2") == {"latent_rel": 0.1,
                                                 "image_rel": 0.1}
    names = [m["name"] for m in bench.metrics("story-768-2ref-b2", True)]
    assert names == ["frames_per_call.serve"]
    assert bench.reader("frames_per_call.serve")({"units": 8}) == 4.0
    assert [m["name"] for m in bench.metrics("story-768-2ref-b2", False)] \
        == ["frames_per_s", "setup_s"]


def test_names_that_are_no_file_name_are_refused():
    with pytest.raises(ValueError):
        Bench().config("../BENCHMARK")


def test_the_idle_share_reads_the_device_only_stretch():
    """The stretch recorded without the host gives the busy time and the
    kernels; the one with the host only names the gaps."""
    dev = [(0.0, 1.0, "elementwise_kernel")]
    first = trace.reduce_events(dev, [], window_s=1.25)
    second = trace.reduce_events(dev, [(1.0, 2.0, "aten::linear")],
                                 window_s=2.0)
    s = trace.merge(first, second)
    assert s["busy_s"] == 1.0 and s["window_s"] == 1.25
    assert s["idle_gaps"] == second["idle_gaps"]
    assert s["host_traced"] == {"busy_s": 1.0, "window_s": 2.0}
    assert readers.idle_share({"job": "serve", "trace": s}, "serve") == \
        pytest.approx(20.0)


class FakeProfiler:
    """Records where each start and stop falls."""

    def __init__(self, where):
        self.where, self.log = where, []
        self.touched, self.active, self.summary = 0, False, None

    def start(self):
        self.log.append(("start", self.where()))
        self.active = True

    def stop(self):
        self.log.append(("stop", self.where()))
        self.active = False


@pytest.mark.parametrize("cell,per", [("story-frame-noref-b8", 1),
                                      ("story-frame-3ref-b4", 2)])
def test_a_traced_frame_profiles_steps_20_to_23_then_24_to_27(cell, per):
    import torch

    from benchmark.run import Run
    from benchmark.tests.tiny import tiny
    torch.set_num_threads(2)
    bench = Bench()
    w = bench.cell(cell)
    traffic = dict(bench.traffic(w["traffic"]), batch=2)
    run = Run(bench, cell, 5, 0.0, False, "cpu",
              tiny(bench.config(w["config"]), steps=30), traffic,
              torch.float32)
    k = run.kind
    k.setup()
    k.warm_up()
    before = k.unet_calls
    prof = FakeProfiler(lambda: (k.unet_calls - before - 1) // per)
    k.profile_call(prof)
    k.call(0)
    # each action runs as the UNet's pass of that denoise step begins
    assert prof.log == [("start", 20), ("stop", 24), ("start", 24),
                        ("stop", 28)]
    assert k.unet_calls - before == 30 * per


def test_a_traced_training_run_profiles_two_micro_steps_then_a_third():
    from benchmark.tests.runs import cpu_run
    run = cpu_run("train-stage2-b12")
    k = run.kind
    k.setup()
    k.warm_up()
    prof = FakeProfiler(lambda: k.micro)
    k.profile_call(prof)
    for m in range(k.k, k.k + 4):
        k.call(m)
    s = k.k
    # micro is the micro-step running (or about to): started before s and
    # stopped after s + 1, then started before s + 2 and stopped after it
    assert prof.log == [("start", s), ("stop", s + 1), ("start", s + 2),
                        ("stop", s + 2)]
    assert k.profiled_kept == [k.kept[s], k.kept[s + 1]]
