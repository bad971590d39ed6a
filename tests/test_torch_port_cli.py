"""The port's entry points (storygen_tpu_torch/scripts/) on the CPU with tiny
models: every flag of each JAX script is accepted (but the named swaps and
deferrals), the inference CLI's PNGs equal the pipeline's own frames, the
precompute -> train -> export -> inference chain runs from YAML and from a
TrainConfig, StoryService rejects what the JAX one rejects, and an HTTP
round trip on port 0 works.

The scripts render and train at 512 px, as the JAX ones do; the tiny UNet
keeps attention off its 64 x 64 latent level (CLI_UNET), and the tests run
on 2 threads: the tier-1 run's 6 workers share the host's cores."""
import base64
import functools
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import PROMPTS, write_bpe_files, write_storysalon_tree
from storygen_tpu_torch.configs import TrainConfig
from storygen_tpu_torch.data.datasets import PrecomputedLatentDataset
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.pipeline import seeded_draws
from storygen_tpu_torch.scripts import (compare_quality, export_checkpoint,
                                        inference, inference_coco_val,
                                        precompute_latents, run_chain,
                                        run_quality, run_quality_suite, serve,
                                        study_knobs, train)
from storygen_tpu_torch.scripts.common import load_pipeline
from storygen_tpu_torch.utils.image import decode_png, read_png
from tests.torch_port_util import cli_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each JAX script's flags that the port's script does not take:
# --platform became --device, run_quality's --orbax_step became
# --state_step and export_checkpoint's --orbax became --ckpt (the
# trainer's torch_io states); the JAX precompute script never reads its
# --batch
NOT_TAKEN = {
    "inference.py": {"--platform"},
    "precompute_latents.py": {"--batch"},
    "train.py": {"--platform"},
    "inference_coco_val.py": {"--platform"},
    "serve.py": {"--platform"},
    "run_quality.py": {"--platform", "--orbax_step"},
    "run_quality_suite.py": set(),
    "run_chain.py": {"--platform"},
    "compare_quality.py": set(),
    "study_knobs.py": set(),
    "export_checkpoint.py": {"--orbax"},
}
# and the flags it adds: the device, the torch.distributed backend of the
# multi-process ones, run_quality's trainer state, and run_chain's two
# training configs (the JAX script hard-codes configs that name a tokenizer
# outside the repository)
ADDED = {"train.py": {"--backend"}, "serve.py": {"--backend"},
         "run_quality.py": {"--state_step"},
         "run_chain.py": {"--stage1_config", "--stage2_config"},
         "export_checkpoint.py": {"--ckpt"}}
# the scripts that run no model, so take no --device
NO_DEVICE = {"compare_quality.py", "export_checkpoint.py"}
SCRIPTS = {"inference.py": inference,
           "precompute_latents.py": precompute_latents, "train.py": train,
           "inference_coco_val.py": inference_coco_val, "serve.py": serve,
           "run_quality.py": run_quality,
           "run_quality_suite.py": run_quality_suite,
           "run_chain.py": run_chain, "compare_quality.py": compare_quality,
           "study_knobs.py": study_knobs,
           "export_checkpoint.py": export_checkpoint}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A diffusers folder of tiny seeded models with a tokenizer/."""
    root = str(tmp_path_factory.mktemp("cli") / "ckpt")
    write_bpe_files(root + "_tok", PROMPTS, 200)
    return cli_folder(root, Tokenizer(root + "_tok"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("salon"))
    write_storysalon_tree(root, stories=3, frames=4, size=512)
    return root


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_flags_of_the_jax_scripts_are_taken(script, capsys):
    with open(os.path.join(REPO, "scripts", script)) as f:
        jax_flags = set(re.findall(r'add_argument\(\s*"(--\w[\w-]*)"',
                                   f.read()))
    assert jax_flags >= NOT_TAKEN[script]
    with pytest.raises(SystemExit):
        SCRIPTS[script].parse_args(["--help"])
    help_text = capsys.readouterr().out
    ours = set(re.findall(r"(--\w[\w-]*)", help_text)) - {"--help"}
    device = set() if script in NO_DEVICE else {"--device"}
    assert ours == (jax_flags - NOT_TAKEN[script] | device
                    | ADDED.get(script, set()))
    assert ("--device DEVICE" in help_text) == (script not in NO_DEVICE)


def test_inference_pngs_equal_the_pipeline(folder, tmp_path):
    out = str(tmp_path / "out")
    common = ["--ckpt", folder, "--logdir", out, "--device", "cpu",
              "--num_inference_steps", "1", "--seed", "3"]
    inference.main(common + ["--prompt", *PROMPTS[:2]])
    pipe = load_pipeline(folder, "cpu")
    frames = pipe.generate_story(list(PROMPTS[:2]), num_inference_steps=1,
                                 guidance_scale=7.0, seed=3)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            read_png(os.path.join(out, f"story_frame{i}.png")),
            inference.to_u8(f))
    # one prompt: stage "no", 2 samples
    inference.main(common + ["--prompt", PROMPTS[2], "--stage", "no",
                             "--num_sample_per_prompt", "2"])
    want = pipe(stage="no", prompt=[PROMPTS[2]], num_inference_steps=1,
                guidance_scale=7.0, num_images_per_prompt=2,
                draw=functools.partial(seeded_draws(pipe.device, 3), 0))
    for s in range(2):
        np.testing.assert_array_equal(
            read_png(os.path.join(out, f"{3 + s}_output.png")),
            inference.to_u8(want[s]))


def test_precompute_train_export_inference_chain(folder, tree, tmp_path,
                                                 capsys):
    lat = str(tmp_path / "latents")
    precompute_latents.main(["--ckpt", folder, "--dataset", tree, "--out",
                             lat, "--device", "cpu"])
    ds = PrecomputedLatentDataset(lat)
    assert len(ds) == 2  # two train stories of one 4-frame window each
    item = ds[0]
    assert item["latent_moments"].shape == (64, 64, 8)
    assert item["ref_latent_moments"].shape == (3, 64, 64, 8)
    assert item["mask"].shape == (512, 512, 1)
    tok = Tokenizer(os.path.join(folder, "tokenizer"))
    np.testing.assert_array_equal(item["input_ids"], tok([PROMPTS[3]])[0])

    # stage 2 from the images, read from YAML
    cfg = dict(pretrained_model_path=folder, dataset_path=tree,
               logdir=str(tmp_path / "log_images"), train_steps=1,
               train_batch_size=1, gradient_accumulation_steps=1,
               checkpointing_steps=1, loader_threads=1, seed=0,
               mixed_precision="fp32", mesh_shape=[8])
    path = str(tmp_path / "stage2.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    state = train.main(["--stage", "stage2", "--config", path, "--device",
                        "cpu"])
    assert len(state.losses) == 1 and np.isfinite(state.losses[0])
    assert "asks for 8 devices" in capsys.readouterr().out
    export = os.path.join(cfg["logdir"], "checkpoint_1")
    assert os.path.isdir(os.path.join(export, "tokenizer"))

    # stage 2 from the latents, 8-bit Adam, straight through run()
    lcfg = TrainConfig(**{**cfg, "mesh_shape": (8,),
                          "logdir": str(tmp_path / "log_latents")},
                       latents_path=lat, use_8bit_adam=True)
    state = train.run("stage2", lcfg, "cpu")
    assert len(state.losses) == 1 and np.isfinite(state.losses[0])

    # inference from the export
    out = str(tmp_path / "story")
    inference.main(["--ckpt", export, "--logdir", out, "--device", "cpu",
                    "--num_inference_steps", "1", "--stage", "no",
                    "--num_sample_per_prompt", "1", "--prompt", PROMPTS[0]])
    assert read_png(os.path.join(out, "0_output.png")).shape == (512, 512, 3)


def test_inference_coco_val_keeps_sample_0(folder, tmp_path):
    """One val image: the output is the one candidate that the JAX script
    keeps without a scorer, rendered with seeded_draws(1000 * i) and
    written by PIL under the val image's name."""
    from PIL import Image

    from storygen_tpu_torch.data.datasets import COCOValMultiSegDataset
    root = str(tmp_path / "coco")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "make_synth_coco.py"),
                    "--root", root, "--images", "1", "--size", "64"],
                   check=True, capture_output=True)
    os.rename(os.path.join(root, "train2017"), os.path.join(root, "val2017"))
    for kind in ("instances", "captions"):
        os.rename(os.path.join(root, "annotations", f"{kind}_train2017.json"),
                  os.path.join(root, "annotations", f"{kind}_val2017.json"))
    out = str(tmp_path / "out")
    inference_coco_val.main(["--ckpt", folder, "--coco_root", root,
                             "--logdir", out,
                             "--num_inference_steps", "1", "--device",
                             "cpu"])
    pipe = load_pipeline(folder, "cpu")
    ds = COCOValMultiSegDataset(root)
    for i in range(len(ds)):
        sample = ds[i]
        want = pipe(stage="multi-image-condition", prompt=[sample["prompt"]],
                    image_prompt=sample["ref_images"][:, None],
                    prev_prompt=[[p] for p in sample["ref_prompts"]],
                    num_inference_steps=1,
                    draw=functools.partial(seeded_draws(pipe.device,
                                                        1000 * i), 0))
        path = str(tmp_path / "want.jpg")
        Image.fromarray(inference.to_u8(want[0])).save(path)
        name = os.path.basename(sample["image_path"])
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(out, name))),
            np.asarray(Image.open(path)))


class _Recorder:
    """A stand-in pipeline that records generate_story's arguments."""
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def generate_story(self, prompts, **kw):
        self.calls.append((prompts, kw))
        return [np.zeros((4, 4, 3), np.float32)] * len(prompts)


BAD_REQUESTS = [
    {"prompt": ["x"]},
    {"prompts": "a fox"},
    {"prompts": []},
    {"prompts": ["a", 3]},
    {"prompts": ["a"], "num_inference_steps": "many"},
    {"prompts": ["a"], "guidance_scale": "high"},
    {"prompts": ["a"], "seed": "s"},
    {"prompts": ["a"], "max_refs": "all"},
    {"prompts": ["a"], "fused": True, "extra": 1},
]


def test_story_service_rejects_what_jax_rejects():
    from scripts import serve as jax_serve
    for req in BAD_REQUESTS:
        with pytest.raises(ValueError) as ours:
            serve.StoryService(_Recorder()).handle_story(dict(req))
        with pytest.raises(ValueError) as ref:
            jax_serve.StoryService(_Recorder()).handle_story(dict(req))
        assert str(ours.value) == str(ref.value), req
    # accepted: the same arguments, the seed as the port's draws' seed
    req = {"prompts": ["a", "b"], "num_inference_steps": "3", "height": 64,
           "width": 64, "guidance_scale": 7, "image_guidance_scale": "3.5",
           "sampler": "dpm++", "seed": 5, "max_refs": 2,
           "normalize_refs": 1, "reuse_latents": 0, "fused": True}
    ours, ref = _Recorder(), _Recorder()
    out = serve.StoryService(ours).handle_story(dict(req))
    jax_serve.StoryService(ref).handle_story(dict(req))
    (p1, kw1), (p2, kw2) = ours.calls[0], ref.calls[0]
    assert p1 == p2 and kw1.pop("seed") == 5
    assert "seed" not in kw2 and kw2.pop("rng") is not None
    assert kw1 == kw2
    assert decode_png(base64.b64decode(out["frames"][0])).shape == (4, 4, 3)


def test_story_service_refuses_fused_with_reuse_latents(folder):
    svc = serve.StoryService(load_pipeline(folder, "cpu"))
    with pytest.raises(ValueError, match="pick one"):
        svc.handle_story({"prompts": ["a"], "fused": True,
                          "reuse_latents": True})


def test_http_round_trip_on_port_0(folder):
    ready = []
    done = threading.Event()
    thread = threading.Thread(target=lambda: (serve.main(
        ["--ckpt", folder, "--port", "0", "--device", "cpu"],
        on_ready=lambda srv: (ready.append(srv), done.set()))), daemon=True)
    thread.start()
    assert done.wait(120)
    srv = ready[0]
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.load(r) == {"ok": True, "devices": 1}
        body = json.dumps({"prompts": list(PROMPTS[:2]),
                           "num_inference_steps": 1, "height": 64,
                           "width": 64, "seed": 2}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/story", body), timeout=120) as r:
            reply = json.load(r)
        frames = [decode_png(base64.b64decode(f)) for f in reply["frames"]]
        assert [f.shape for f in frames] == [(64, 64, 3)] * 2
        with pytest.raises(urllib.error.HTTPError) as bad:
            urllib.request.urlopen(urllib.request.Request(
                base + "/story", b'{"prompts": []}'), timeout=60)
        assert bad.value.code == 400
    finally:
        srv.shutdown()
        thread.join(60)
    assert not thread.is_alive()
