"""The port's quality scripts (storygen_tpu_torch/scripts/run_quality,
run_quality_suite, run_chain, compare_quality, study_knobs,
make_synth_storysalon / make_synth_coco and COCO-val's PickScore
re-ranking) on the CPU with tiny models: the synthetic trees byte for byte
the top-level scripts', compare() equal to the JAX script's, the suite's
state swap, run_chain's refusal of a final step that no state would reach,
the whole chain with its JSONs (the final state swapped into the stage-1
export scoring as the trainer's export does), and the re-ranked COCO-val pick equal to
the argmax of PickScorer.score on the same candidates. The scripts'
passes run at 2 steps here (CONFIGS monkeypatched) and the scorer at tiny
widths; the card runs them as written (chip_smoke.py, phase quality)."""
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import PROMPTS, write_bpe_files
from storygen_tpu_torch.configs import (CLIPConfig, CLIPTextConfig,
                                        CLIPVisionConfig, UNetConfig,
                                        VAEConfig)
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.scripts import (compare_quality, inference_coco_val,
                                        make_synth_coco,
                                        make_synth_storysalon, run_chain,
                                        run_quality, run_quality_suite,
                                        study_knobs)
from tests.torch_port_util import CLI_UNET, TINY_VAE, cli_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SCORER = CLIPConfig(
    CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, pad_token_id=1),
    CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     image_size=32, patch_size=16),
    projection_dim=16)
FAST_CONFIGS = [("exact", "ddim", 2, 1), ("dpm25_ri2", "dpm++", 2, 2),
                ("dpm25", "dpm++", 2, 1)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_scorer(monkeypatch):
    """ensure_clip at the tiny widths, wherever the scripts call it."""
    orig = run_quality.ensure_clip
    monkeypatch.setattr(run_quality, "ensure_clip",
                        lambda path, tok, config=TINY_SCORER, seed=0:
                        orig(path, tok, config, seed))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality")
    write_bpe_files(str(root / "bpe"), PROMPTS, 100)
    return cli_folder(str(root / "ckpt"), Tokenizer(str(root / "bpe")))


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(a, b):
    files = tree_files(a)
    assert files and files == tree_files(b)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


def test_synth_trees_equal_the_jax_scripts(tmp_path):
    for name, flags in (("make_synth_storysalon", ["--stories", "3",
                                                   "--frames", "4",
                                                   "--test-stories", "1"]),
                        ("make_synth_coco", ["--images", "3"])):
        flags = flags + ["--size", "48"]
        subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                     name + ".py"),
                        "--root", str(tmp_path / "jax" / name)] + flags,
                       check=True, capture_output=True)
        module = {"make_synth_storysalon": make_synth_storysalon,
                  "make_synth_coco": make_synth_coco}[name]
        module.main(["--root", str(tmp_path / "port" / name)] + flags)
        assert_same_tree(str(tmp_path / "jax" / name),
                         str(tmp_path / "port" / name))


def fake_run(seed, n, per_window=True):
    rs = np.random.RandomState(seed)
    out = {"clip_fid": float(rs.rand() * 3)}
    pw = {}
    for key in ("clip_i", "clip_t", "pickscore"):
        v = rs.rand(n)
        out[f"{key}_dist"] = run_quality.dist(v)
        pw[key] = [float(x) for x in v]
    if per_window:
        out["per_window"] = pw
    return out


@pytest.mark.parametrize("case", ["paired", "summary_only", "close"])
def test_compare_equals_the_jax_script(case):
    from scripts import compare_quality as jax_compare
    exact = fake_run(0, 12)
    fast = {"paired": fake_run(1, 12), "summary_only": fake_run(2, 12, False),
            "close": json.loads(json.dumps(exact))}[case]
    assert compare_quality.compare(exact, fast) == jax_compare.compare(
        exact, fast)
    if case == "close":
        assert compare_quality.compare(exact, fast)["certified"]


def test_suite_swap_leaves_the_unet_equal_to_trainable(tmp_path):
    from storygen_tpu_torch.checkpoint import torch_io
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    unet = init_random_(UNet2DConditionModel(UNetConfig(**CLI_UNET)), 1).to(
        torch.bfloat16)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    trainable = {n: torch.randn(p.shape, generator=g)
                 for n, p in unet.named_parameters() if "attn3" in n}
    torch_io.save_checkpoint(str(tmp_path), 3, {"trainable": trainable,
                                                "micro_step": 3})
    names = run_quality.swap_in_state(unet, str(tmp_path), 3)
    assert names == sorted(trainable)
    for k, v in unet.state_dict().items():
        want = trainable[k].to(torch.bfloat16) if k in trainable else before[k]
        assert torch.equal(v, want), k
    torch_io.save_checkpoint(str(tmp_path), 4, {"trainable": {
        "conv_in.weight": before["conv_in.weight"]}})
    with pytest.raises(KeyError, match="stage2"):
        run_quality.swap_in_state(unet, str(tmp_path), 4)


def test_run_chain_refuses_a_final_step_no_state_reaches(tmp_path):
    root = tmp_path / "chain"
    with pytest.raises(ValueError, match="not a multiple"):
        run_chain.main(["--root", str(root), "--data", str(tmp_path),
                        "--steps", "5", "--ckpt_every", "2", "--device",
                        "cpu"])
    assert not root.exists()


def test_chain_and_quality_on_the_cpu(tmp_path, folder, monkeypatch,
                                      tiny_scorer):
    monkeypatch.setattr(run_quality_suite, "CONFIGS", FAST_CONFIGS)
    data, root = str(tmp_path / "salon"), str(tmp_path / "chain")
    make_synth_storysalon.write(data, 2, 4, 64, 1)
    configs = []
    for stage in (1, 2):
        with open(os.path.join(REPO, "configs",
                               f"stage{stage}_tpu_smoke.yml")) as f:
            cfg = yaml.safe_load(f)
        cfg.update(pretrained_model_path=folder,
                   tokenizer_path=os.path.join(folder, "tokenizer"),
                   train_batch_size=1, gradient_accumulation_steps=1,
                   mixed_precision="fp32", loader_threads=1)
        configs.append(str(tmp_path / f"stage{stage}.yml"))
        with open(configs[-1], "w") as f:
            yaml.safe_dump(cfg, f)
    summary = run_chain.main([
        "--root", root, "--data", data, "--stage1_steps", "1", "--steps",
        "2", "--ckpt_every", "1", "--score_steps", "2", "--stage1_config",
        configs[0], "--stage2_config", configs[1], "--device", "cpu"])
    assert os.path.isdir(os.path.join(root, "stage1", "checkpoint_1"))
    assert os.path.isdir(os.path.join(root, "train", "checkpoint_2"))
    assert sorted(summary["quality_curve"]) == ["1", "2"]
    assert sorted(summary["fast_points"]) == [
        "dpm25_ri2_s1", "dpm25_ri2_s2", "dpm25_s2"]
    runs = list(summary["quality_curve"].values()) + list(
        summary["fast_points"].values())
    assert all(r is not None and r["num_windows"] == 1 for r in runs)
    assert [p["step"] for p in summary["loss_curve"]] == [1]
    with open(os.path.join(root, "chain.json")) as f:
        assert json.load(f)["stage2_steps"] == 2

    # the trainer's export of the final state, which the suite scored as
    # that state swapped into the stage-1 export (quality_exact_s2.json)
    metrics = run_quality.main([
        "--root", root, "--data", data, "--skip_train", "--stories", "2",
        "--frames", "4", "--test-stories", "1", "--num_inference_steps", "2",
        "--ckpt_step", "2", "--device", "cpu"])
    # the JAX script's schema
    assert sorted(metrics) == sorted(
        ["clip_i", "clip_t", "clip_fid", "pickscore", "clip_i_dist",
         "clip_t_dist", "pickscore_dist", "per_window", "num_windows",
         "num_inference_steps", "sampler", "ref_feature_interval",
         "checkpoint"])
    assert np.isnan(metrics["clip_fid"])  # one window has no covariance
    assert -1 <= metrics["clip_i"] <= 1 and metrics["per_window"][
        "pickscore"][0] == metrics["pickscore"]
    state = summary["quality_curve"]["2"]
    assert state["checkpoint"].endswith(
        "checkpoints@2 (base " + os.path.join(root, "stage1", "checkpoint_1")
        + ")")
    for key in ("clip_i", "clip_t", "pickscore", "per_window"):
        assert state[key] == metrics[key], key
    res = compare_quality.main([os.path.join(root, "quality_exact_s2.json"),
                                os.path.join(root,
                                             "quality_dpm25_ri2_s2.json")])
    assert res["fast_config"]["ref_feature_interval"] == 2


def test_coco_val_keeps_the_pickscore_argmax(tmp_path, folder, monkeypatch):
    from PIL import Image
    from storygen_tpu_torch.data.datasets import COCOValMultiSegDataset
    from storygen_tpu_torch.evaluation.clip_scores import PickScorer
    coco, out = str(tmp_path / "coco"), str(tmp_path / "out")
    make_synth_coco.write(coco, 1, 64, "val2017")
    scorer = str(tmp_path / "scorer")
    run_quality.ensure_clip(scorer, os.path.join(folder, "tokenizer"),
                            TINY_SCORER)
    render, rendered = inference_coco_val.candidates, []

    def record(*a, **kw):
        rendered.append(render(*a, **kw))
        return rendered[-1]
    monkeypatch.setattr(inference_coco_val, "candidates", record)
    kept = inference_coco_val.main([
        "--ckpt", folder, "--coco_root", coco, "--logdir", out,
        "--pickscore_processor", scorer, "--pickscore_model", scorer,
        "--num_samples", "3", "--samples_per_batch", "2",
        "--num_inference_steps", "1", "--device", "cpu"])
    sample = COCOValMultiSegDataset(coco)[0]
    [cands] = rendered
    assert len(cands) == 3
    scores = PickScorer(scorer, scorer, "cpu").score(
        sample["prompt"], [Image.fromarray(c) for c in cands])
    name = os.path.basename(sample["image_path"])
    assert kept == {name: int(np.argmax(scores))}
    Image.fromarray(cands[kept[name]]).save(str(tmp_path / "want.jpg"))
    assert filecmp.cmp(os.path.join(out, name), str(tmp_path / "want.jpg"),
                       shallow=False)


def test_study_knobs_on_tiny_models():
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    unet = init_random_(UNet2DConditionModel(UNetConfig(**dict(
        CLI_UNET, cross_attention_dim=16))), 0)
    vae = init_random_(AutoencoderKL(VAEConfig(**TINY_VAE)), 0)
    configs = [(n, 2, s, i) for n, _, s, i in study_knobs.CONFIGS]
    res = study_knobs.run_knobs(unet, vae, torch.device("cpu"), side=64,
                                configs=configs)
    assert list(res) == [c[0] for c in study_knobs.CONFIGS]
    exact = res["exact_ddim50"]
    assert exact["latent_rel_rmse_vs_exact"] == exact[
        "pixel_mad_vs_exact"] == 0.0
    assert all(r["frames_per_s"] > 0 and np.isfinite(
        r["latent_rel_rmse_vs_exact"]) for r in res.values())
    assert res["dpmpp25"]["latent_rel_rmse_vs_exact"] > 0
