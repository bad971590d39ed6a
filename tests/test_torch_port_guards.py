"""Guards of the port that need no GPU: it never imports JAX, Flax or the
JAX package, its build names sm_90a and a build/ output, its kernel
modules call no library kernel in place of their own, and its entry points
(training, serving and the dataset build) refuse to run without a card
unless the caller asks for the CPU, and never move models behind the
caller's back."""
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from storygen_tpu_torch.checkpoint import hf_import
from storygen_tpu_torch.configs import (CLIPTextConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.data_process import dedup, detectors
from storygen_tpu_torch.data_process.inpaint import Inpainter
from storygen_tpu_torch.models.clip_text import CLIPTextModel
from storygen_tpu_torch.models.unet import UNet2DConditionModel
from storygen_tpu_torch.models.vae import AutoencoderKL
from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.pipeline import (StoryGenPipeline, StoryGenSampler,
                                         seeded_draws)
from storygen_tpu_torch.scripts import (bench, bench_story, bench_train,
                                        inference, inference_coco_val,
                                        precompute_latents, serve, train)
from storygen_tpu_torch.training import trainer
from tests.torch_port_util import tokenizer

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
        "import storygen_tpu_torch.ops.upconv, "
        "storygen_tpu_torch.scripts.export_checkpoint\n"
        "import storygen_tpu_torch.configs, storygen_tpu_torch.data.loader\n"
        "import storygen_tpu_torch.training.losses, "
        "storygen_tpu_torch.training.optim\n"
        "import storygen_tpu_torch.training.steps, "
        "storygen_tpu_torch.training.trainer\n"
        "import storygen_tpu_torch.utils.logging, "
        "storygen_tpu_torch.utils.image\n"
        "import storygen_tpu_torch.checkpoint.hf_import, "
        "storygen_tpu_torch.checkpoint.hf_export\n"
        "import storygen_tpu_torch.checkpoint.torch_io, "
        "storygen_tpu_torch.training.optim8bit\n"
        "import storygen_tpu_torch.data.datasets, "
        "storygen_tpu_torch.data.tokenizer\n"
        "import storygen_tpu_torch.scripts.common, "
        "storygen_tpu_torch.scripts.inference\n"
        "import storygen_tpu_torch.scripts.precompute_latents, "
        "storygen_tpu_torch.scripts.train\n"
        "import storygen_tpu_torch.scripts.inference_coco_val, "
        "storygen_tpu_torch.scripts.serve\n"
        "import storygen_tpu_torch.diffusion.schedule, "
        "storygen_tpu_torch.diffusion.dpm_solver\n"
        "import storygen_tpu_torch.diffusion.euler, "
        "storygen_tpu_torch.diffusion.pndm, "
        "storygen_tpu_torch.diffusion.lms\n"
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
        "import storygen_tpu_torch.parallel.mesh, "
        "storygen_tpu_torch.parallel.multihost\n"
        "import storygen_tpu_torch.parallel.serving, "
        "storygen_tpu_torch.parallel.tensor\n"
        "import storygen_tpu_torch.utils.profiling, "
        "storygen_tpu_torch.utils.util, storygen_tpu_torch.native\n"
        "import storygen_tpu_torch.detection.yolov7, "
        "storygen_tpu_torch.data_process.extract\n"
        "import storygen_tpu_torch.data_process.dedup, "
        "storygen_tpu_torch.data_process.masking\n"
        "import storygen_tpu_torch.data_process.detectors, "
        "storygen_tpu_torch.data_process.inpaint\n"
        "import storygen_tpu_torch.data_process.align, "
        "storygen_tpu_torch.data_process.caption\n"
        "import storygen_tpu_torch.scripts.build_dataset\n"
        "import storygen_tpu_torch.models.clip_vision, "
        "storygen_tpu_torch.evaluation.clip_scores\n"
        "import storygen_tpu_torch.evaluation.fid, "
        "storygen_tpu_torch.evaluation.preprocess\n"
        "import storygen_tpu_torch.scripts.run_quality, "
        "storygen_tpu_torch.scripts.run_quality_suite\n"
        "import storygen_tpu_torch.scripts.run_chain, "
        "storygen_tpu_torch.scripts.compare_quality\n"
        "import storygen_tpu_torch.scripts.study_knobs, "
        "storygen_tpu_torch.scripts.make_synth_storysalon\n"
        "import storygen_tpu_torch.scripts.make_synth_coco\n"
        "import storygen_tpu_torch.scripts.bench, "
        "storygen_tpu_torch.scripts.bench_story\n"
        "import storygen_tpu_torch.scripts.bench_train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'storygen_tpu', 'transformers', "
        "'tokenizers', 'regex'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    """No JAX, Flax, JAX package or HuggingFace package anywhere, but
    transformers inside a function of the caption stage's adapter
    (data_process/caption.py), for the caller that has a checkpoint."""
    pat = re.compile(
        r"^(\s*)(import|from)\s+(jax|flax|jaxlib|storygen_tpu|transformers|"
        r"tokenizers|regex)(\.|\s|$)", re.M)
    caption = PORT / "data_process" / "caption.py"
    for p in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        found = pat.findall(p.read_text())
        if p == caption:
            assert found and all(indent and pkg == "transformers"
                                 for indent, _, pkg, _ in found), p
        else:
            assert not found, p


def test_nvcc_command_targets_sm90a_into_build_dir():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"flash_fwd.cu", "flash_bwd.cu",
                                      "geglu_matmul.cu", "conv3x3.cu",
                                      "downconv3x3.cu", "upconv3x3.cu",
                                      "upconv_dx3x3.cu", "study_online.cu",
                                      "study_bounded.cu", "study_bnd2.cu",
                                      "study_qk.cu", "study_int8.cu"}
    assert {p.name for p in _build.headers()} == {"study_mma.cuh",
                                                  "conv_mma.cuh",
                                                  "conv_wgmma.cuh",
                                                  "hopper.cuh",
                                                  "flash_wgmma.cuh",
                                                  "flash_bwd_wgmma.cuh",
                                                  "geglu_wgmma.cuh",
                                                  "study_wgmma.cuh"}
    out = _build.lib_path(srcs)
    nvcc = "/usr/local/cuda/bin/nvcc"
    for src in srcs:
        obj = out.with_name(src.stem + ".o")
        cmd = _build.compile_command(nvcc, src, obj)
        assert cmd[cmd.index("-gencode") + 1] == \
            "arch=compute_90a,code=sm_90a"
        assert {"-O3", "-c", "-Xcompiler", "-fPIC"} <= set(cmd)
        # ptxas reports every kernel's registers and spills
        assert cmd[cmd.index("-Xptxas") + 1] == "-v"
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
    "study_online.cu", "study_bounded.cu", "study_bnd2.cu", "study_qk.cu",
    "study_int8.cu", "study_mma.cuh", "conv_mma.cuh", "conv_wgmma.cuh",
    "hopper.cuh", "flash_wgmma.cuh", "geglu_wgmma.cuh", "study_wgmma.cuh",
    "upconv.py", "upconv3x3.cu", "upconv_dx3x3.cu"])
def test_kernel_modules_call_no_library_kernel(name):
    src = (PORT / ("ops" if name.endswith(".py") else "csrc") / name
           ).read_text()
    for banned in ("scaled_dot_product_attention", "torch.compile",
                   "cpp_extension", "flash_attn", "xformers", "triton.ops",
                   "cudnn", "cublas", "cutlass"):
        assert banned not in src.lower(), (name, banned)


def _includes(name, seen=None):
    """The csrc headers that csrc/<name> includes, directly or through
    another header."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'^#include "([^"]+)"',
                          (PORT / "csrc" / name).read_text(), re.M):
        if inc not in seen:
            seen.add(inc)
            _includes(inc, seen)
    return seen


@pytest.mark.parametrize("name", ["study_online.cu", "study_bounded.cu",
                                  "study_bnd2.cu", "flash_fwd.cu"])
def test_wgmma_attention_sources_hold_no_mma_sync_path(name):
    """S1, S2 and F / M / L run wgmma fed by TMA only: neither their sources
    nor any header they include issue mma.sync or cp.async, none but
    hopper.cuh (whose ldsm_x4_at is the conv prologue's) holds an ldmatrix
    or calls one, and none includes the mma.sync kernels' study_mma.cuh."""
    files = [name] + sorted(_includes(name))
    assert "study_mma.cuh" not in files, files
    assert {"hopper.cuh", "flash_wgmma.cuh"} <= set(files), files
    for f in files:
        src = (PORT / "csrc" / f).read_text()
        code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
        banned = ["mma.sync", "cp.async.ca", "cp.async.cg", "cp.async.commit"]
        if f != "hopper.cuh":
            banned += ["ldmatrix", "ldsm_"]
        for b in banned:
            assert b not in code, (f, b)
    wg = "\n".join((PORT / "csrc" / f).read_text() for f in files)
    assert "wgmma.mma_async" in wg and "cp.async.bulk.tensor" in wg


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
    # the story paths: without a card the sampler and the pipeline behind
    # story_rollout and generate_story(fused=True) refuse to be built;
    # given device="cpu" both run there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoryGenSampler(unet, vae).story_rollout
    sampler = StoryGenSampler(unet, vae, device="cpu")
    text = torch.zeros((2, 1, 77, 8))
    frames = sampler.story_rollout(
        text[0], text, seeded_draws("cpu", 0), 7.5, 3.5,
        num_inference_steps=1, height=64, width=64)
    assert frames.shape == (2, 1, 64, 64, 3) and frames.device.type == "cpu"
    pipe = StoryGenPipeline(unet, vae, clip, tokenizer, device="cpu")
    frames = pipe.generate_story(["a", "b"], fused=True,
                                 num_inference_steps=1, height=64, width=64)
    assert [f.shape for f in frames] == [(64, 64, 3)] * 2
    # checkpoint folders: the loader, and the trainer that loads
    # pretrained_model_path, refuse without a card; given device="cpu"
    # they load there
    root = str(tmp_path / "folder")
    pipe.save_pretrained(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hf_import.load_diffusers_pretrained(root)
    loaded = hf_import.load_diffusers_pretrained(root, device="cpu")
    assert {p.device.type for k in ("unet", "vae", "text_encoder")
            for p in loaded[k].parameters()} == {"cpu"}
    cfg = TrainConfig(logdir=str(tmp_path), pretrained_model_path=root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.build_models(cfg)
    assert trainer.build_models(cfg, "cpu")["unet"].config == unet.config
    _scripts_need_a_card_unless_asked_for_cpu(tmp_path)
    _timers_need_a_card_unless_asked_for_cpu(monkeypatch)


# each timer's main: argv, and the keyword arguments its run must get
TIMERS = [
    (bench, [], dict(batch=1, conv="default")),
    (bench_story, ["--fused", "--conv", "fused"],
     dict(reuse=False, fused=True, conv="fused")),
    (bench_train, ["--stage", "full", "--opt", "8bit", "--precomputed"],
     dict(stage="full", opt="8bit", precomputed=True, batch=4, iters=5,
          remat=True, conv="default"))]


def _timers_need_a_card_unless_asked_for_cpu(monkeypatch):
    """The timers' main refuses without a card before it builds a model;
    with --device cpu it builds its models there and runs at the JAX
    script's settings (the full-width models and the run itself stand in
    here: at 512 px and full width the CPU would take hours)."""
    unet, vae, clip = _tiny_serving_models()
    for script, argv, want in TIMERS:
        assert script.parse_args(argv).device == "cuda"
        built, ran = [], []
        monkeypatch.setattr(script, "full_width_models", lambda dev, conv:
                            built.append((dev, conv)) or {
                                "unet": unet, "vae": vae,
                                "text_encoder": clip})
        monkeypatch.setattr(script, "run", lambda models, **kw: ran.append(
            (models, kw)) or ({}, []))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(argv)
        assert not built and not ran
        script.main(argv + ["--device", "cpu"])
        assert built == [(torch.device("cpu"), want["conv"])]
        (models, kw), = ran
        assert models["unet"] is unet and kw.pop("device").type == "cpu"
        assert kw == want, script


def test_timers_take_the_jax_scripts_flags(monkeypatch):
    """bench.py, scripts/bench_story.py and scripts/bench_train.py's flags
    and switches parse; the JAX-only ones (--attn, --variant,
    --ref-encode) are refused."""
    assert bench.parse_args(["--batch", "2"]).batch == 2
    args = bench_story.parse_args(["--reuse-latents"])
    assert args.reuse_latents and not args.fused
    assert bench_story.parse_args(["--fused"]).fused
    monkeypatch.setenv("STORY_REUSE_LATENTS", "1")
    assert bench_story.parse_args([]).reuse_latents
    monkeypatch.setenv("STORY_FUSED", "1")
    with pytest.raises(SystemExit):  # two different stories
        bench_story.parse_args([])
    args = bench_train.parse_args(
        ["--batch", "2", "--no-remat", "--precomputed", "--stage", "coco",
         "--opt", "8bit", "--iters", "3"])
    assert (args.batch, args.remat, args.precomputed, args.stage, args.opt,
            args.iters) == (2, False, True, "coco", "8bit", 3)
    defaults = bench_train.parse_args([])
    assert (defaults.batch, defaults.remat, defaults.stage, defaults.opt,
            defaults.iters, defaults.conv) == (4, True, "stage2", "fp32", 5,
                                               "default")
    assert bench_train.parse_args(["--remat"]).remat
    for flag in (["--attn", "xla"], ["--variant", "bnd"],
                 ["--ref-encode", "map"]):
        with pytest.raises(SystemExit):
            bench_train.parse_args(flag)
    for script in (bench, bench_story, bench_train):
        with pytest.raises(SystemExit):
            script.parse_args(["--conv", "halo"])


def _scripts_need_a_card_unless_asked_for_cpu(tmp_path):
    """Each script's --device defaults to cuda and refuses without a card;
    with --device cpu it runs (on an empty dataset, or at train_steps 0)."""
    from chip_smoke import write_bpe_files, write_storysalon_tree
    from storygen_tpu_torch.data.tokenizer import Tokenizer
    from tests.torch_port_util import cli_folder
    write_bpe_files(str(tmp_path / "bpe"), ["a fox"], 10)
    root = cli_folder(str(tmp_path / "cli"), Tokenizer(str(tmp_path / "bpe")))
    salon = str(tmp_path / "salon")
    write_storysalon_tree(salon, stories=2, frames=4, size=64)
    coco = tmp_path / "coco"
    (coco / "annotations").mkdir(parents=True)
    (coco / "annotations" / "instances_val2017.json").write_text(
        '{"images": [], "annotations": [], "categories": []}')
    out = str(tmp_path / "out")
    cfg = str(tmp_path / "cfg.yml")
    with open(cfg, "w") as f:
        f.write(f"pretrained_model_path: {root}\ndataset_path: {salon}\n"
                f"logdir: {out}\ntrain_steps: 0\ntrain_batch_size: 1\n")
    runs = [
        (inference, ["--ckpt", root, "--logdir", out, "--prompt", "a fox",
                     "--stage", "no", "--num_inference_steps", "1",
                     "--num_sample_per_prompt", "1"]),
        (precompute_latents, ["--ckpt", root, "--dataset", out, "--out",
                              out]),
        (train, ["--config", cfg]),
        (inference_coco_val, ["--ckpt", root, "--coco_root", str(coco),
                              "--logdir", out]),
        (serve, ["--ckpt", root, "--port", "0"])]
    for script, argv in runs:
        assert script.parse_args(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(argv)
    for script, argv in runs:
        if script is serve:
            script.main(argv + ["--device", "cpu"], on_ready=lambda srv: (
                threading.Thread(target=srv.shutdown).start()))
        else:
            script.main(argv + ["--device", "cpu"])
    assert os.path.exists(os.path.join(out, "0_output.png"))


def test_entry_points_refuse_models_elsewhere():
    """A model that is not on the device asked for raises; it is not
    moved."""
    unet, vae, clip = _tiny_serving_models()
    with torch.device("meta"):
        meta_vae = type(vae)(vae.config)
        meta_unet = type(unet)(unet.config)
    with pytest.raises(ValueError, match="vae has parameters on"):
        StoryGenPipeline(unet, meta_vae, clip, lambda p: None, device="cpu")
    with pytest.raises(ValueError, match="vae has parameters on"):
        StoryGenSampler(unet, meta_vae, device="cpu")
    with pytest.raises(ValueError, match="vae has parameters on"):
        Inpainter(unet, meta_vae, device="cpu")
    with pytest.raises(ValueError, match="unet has parameters on"):
        Inpainter(meta_unet, vae, device="cpu")
    assert next(meta_vae.parameters()).is_meta
    assert next(meta_unet.parameters()).is_meta


def test_dataset_entry_points_need_a_card_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """The dataset build's device-bearing entry points: the inpainter, the
    YOLOv7 person detector (before it reads its weights), the DINO
    embedder and build_dataset.main without --device."""
    from storygen_tpu_torch.detection import yolov7
    from storygen_tpu_torch.scripts import build_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    unet, vae, _ = _tiny_serving_models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Inpainter(unet, vae)
    assert Inpainter(unet, vae, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolov7.yolov7_person_detector(str(tmp_path / "absent.pt"))
    weights = tmp_path / "yolov7.pt"
    weights.write_bytes(b"")
    for fn in (detectors.yolov7_person_detector,
               detectors.yolo_person_detector):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(str(weights))
    hub = tmp_path / "hub"
    (hub / dedup.DINO_REPO).mkdir(parents=True)
    (hub / "checkpoints").mkdir()
    (hub / "checkpoints" / dedup.DINO_WEIGHTS).write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dedup.dino_embedder(str(hub))
    argv = ["--videos", str(tmp_path), "--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dataset.main(argv)
    build_dataset.main(argv + ["--device", "cpu"])


def test_quality_entry_points_need_a_card_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """The evaluation layer and the quality scripts: the scorers and the
    CLIP loader, and run_quality, run_quality_suite, run_chain and
    study_knobs without --device, refuse without a card; given the CPU the
    scorers load and study_knobs runs (here on tiny models; the scripts'
    CPU runs are in tests/test_torch_port_quality.py)."""
    from chip_smoke import write_bpe_files
    from storygen_tpu_torch.data.tokenizer import Tokenizer
    from storygen_tpu_torch.evaluation import clip_scores
    from storygen_tpu_torch.scripts import (run_chain, run_quality,
                                            run_quality_suite, study_knobs)
    from tests.test_torch_port_quality import TINY_SCORER
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_bpe_files(str(tmp_path / "bpe"), ["a fox"], 10)
    Tokenizer(str(tmp_path / "bpe")).save_pretrained(str(tmp_path / "tok"))
    scorer = str(tmp_path / "scorer")
    run_quality.ensure_clip(scorer, str(tmp_path / "tok"), TINY_SCORER)
    for make in (lambda **kw: hf_import.load_clip_model(scorer, **kw),
                 lambda **kw: clip_scores.CLIPScorer(scorer, **kw),
                 lambda **kw: clip_scores.PickScorer(scorer, scorer, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        got = make(device="cpu")
        model = getattr(got, "model", got)
        assert {p.device.type for p in model.parameters()} == {"cpu"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip_scores.evaluate_directory(str(tmp_path), str(tmp_path), scorer)
    root, data = str(tmp_path / "run"), str(tmp_path / "data")
    runs = [(run_quality, ["--root", root, "--data", data]),
            (run_quality_suite, ["--root", root, "--data", data, "--base",
                                 root]),
            (run_chain, ["--root", root, "--data", data]),
            (study_knobs, [])]
    for script, argv in runs:
        assert script.parse_args(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(argv)
    assert not os.path.exists(root) and not os.path.exists(data)
    unet, vae, _ = _tiny_serving_models()
    monkeypatch.setattr(study_knobs, "knob_models", lambda dev: (unet, vae))
    monkeypatch.setattr(study_knobs, "SIDE", 64)
    monkeypatch.setattr(study_knobs, "CONFIGS", [
        (n, 1, s, i) for n, _, s, i in study_knobs.CONFIGS])
    res = study_knobs.main(["--device", "cpu"])
    assert sorted(res) == sorted(n for n, *_ in study_knobs.CONFIGS)


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
