"""The port's evaluation layer (storygen_tpu_torch/evaluation/, the CLIP
vision tower and CLIPModel of models/clip_vision.py, load_clip_model)
against the JAX package's scorers, which run transformers' CLIPModel, on a
tiny seeded transformers CLIP folder that the test writes with its own BPE
vocab: embeddings, CLIP-I / CLIP-T, PickScore and its argmax, and
evaluate_directory, fp32 rel L2 <= 1e-5, for both text pooling rules
(eos_token_id 2: the largest id; else the first EOS) and both activations
(quick_gelu, gelu); CLIPImageProcessor's pixels on non-square images; the
Frechet distance against JAX's; the text tower's gelu repair against
transformers' CLIPTextModel; and the seeded scorer folder that
run_quality writes, read by transformers."""
import os

import numpy as np
import pytest
import torch

from chip_smoke import PROMPTS, write_bpe_files
from storygen_tpu_torch.configs import CLIPConfig, CLIPTextConfig
from storygen_tpu_torch.data.tokenizer import Tokenizer
from storygen_tpu_torch.evaluation import clip_scores as ours
from storygen_tpu_torch.evaluation import fid as ours_fid
from storygen_tpu_torch.evaluation.preprocess import ImageProcessor

REL = 1e-5
TEXTS = ["a fox", PROMPTS[0], PROMPTS[1] + " " + PROMPTS[2],
         "the owl " * 50]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def write_clip_folder(root: str, bpe: str, eos: int = 49407,
                      act: str = "quick_gelu", seed: int = 0) -> str:
    """A seeded tiny transformers CLIPModel with the port's tokenizer files
    and a CLIPImageProcessor (shortest edge 32, crop 32)."""
    import transformers
    torch.manual_seed(seed)
    cfg = transformers.CLIPConfig(
        text_config={"vocab_size": 49408, "hidden_size": 32,
                     "intermediate_size": 64, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "max_position_embeddings": 77,
                     "eos_token_id": eos, "hidden_act": act},
        vision_config={"hidden_size": 32, "intermediate_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 4,
                       "image_size": 32, "patch_size": 16,
                       "hidden_act": act},
        projection_dim=16)
    model = transformers.CLIPModel(cfg)
    with torch.no_grad():  # a class token and LayerNorms away from init
        for name, p in model.named_parameters():
            if "layer_norm" in name or "layrnorm" in name:
                p.add_(0.1 * torch.randn_like(p))
        model.logit_scale.fill_(1.7)
    model.save_pretrained(root)
    Tokenizer(bpe).save_pretrained(root)
    transformers.CLIPImageProcessor(
        size={"shortest_edge": 32}, crop_size=32).save_pretrained(root)
    return root


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bpe"))
    write_bpe_files(root, PROMPTS + tuple(TEXTS), 200)
    return root


def images(n, seed, sizes=((40, 56), (48, 32), (32, 32), (61, 45))):
    from PIL import Image
    rs = np.random.RandomState(seed)
    return [Image.fromarray(rs.randint(0, 256, sizes[i % len(sizes)] + (3,),
                                       dtype=np.uint8)) for i in range(n)]


@pytest.mark.parametrize("eos,act", [(49407, "quick_gelu"), (2, "quick_gelu"),
                                     (49407, "gelu"), (2, "gelu")])
def test_scorers_equal_the_jax_scorers(tmp_path, bpe, eos, act):
    from storygen_tpu.evaluation import clip_scores as ref
    folder = write_clip_folder(str(tmp_path / "clip"), bpe, eos, act)
    cfg = CLIPConfig.from_json(os.path.join(folder, "config.json"))
    assert cfg.text_config.eos_token_id == eos
    assert cfg.text_config.hidden_act == cfg.vision_config.hidden_act == act
    mine, theirs = ours.CLIPScorer(folder, "cpu"), ref.CLIPScorer(folder)
    gen, gt = images(4, 0), images(4, 1)
    assert rel_l2(mine.image_embed(gen), theirs.image_embed(gen)) <= REL
    assert rel_l2(mine.text_embed(TEXTS), theirs.text_embed(TEXTS)) <= REL
    for fn, args in ((ours.clip_i, (gen, gt)), (ours.clip_t, (gen, TEXTS))):
        a, b = fn(mine, *args), getattr(ref, fn.__name__)(theirs, *args)
        assert abs(a - b) <= REL * abs(b), fn.__name__
    pick, ref_pick = ours.PickScorer(folder, folder, "cpu"), ref.PickScorer(
        folder, folder)
    for prompt in TEXTS[:2]:
        s, r = pick.score(prompt, gen), ref_pick.score(prompt, gen)
        assert rel_l2(s, r) <= REL
        assert pick.best_of(prompt, gen) == ref_pick.best_of(prompt, gen) \
            == int(np.argmax(r))


def test_text_pooling_rules(tmp_path, bpe):
    """eos_token_id 2 (a legacy config) pools at the largest id, any other
    at its first occurrence."""
    from storygen_tpu_torch.checkpoint.hf_import import load_clip_model
    ids = torch.tensor([[49406, 5, 49407, 49407], [49406, 49407, 50000, 2]])
    hidden = torch.arange(2 * 4 * 3.0).reshape(2, 4, 3)
    for eos, rows in ((49407, [2, 1]), (2, [2, 2])):
        model = load_clip_model(write_clip_folder(
            str(tmp_path / str(eos)), bpe, eos), "cpu")
        np.testing.assert_array_equal(model.text_model.pooled(hidden, ids),
                                      hidden[[0, 1], rows])


def test_evaluate_directory_equals_jax(tmp_path, bpe):
    from storygen_tpu.evaluation import clip_scores as ref
    folder = write_clip_folder(str(tmp_path / "clip"), bpe, seed=3)
    gen_dir, gt_dir, salon = (tmp_path / "gen", tmp_path / "gt",
                              tmp_path / "salon")
    gen_dir.mkdir()
    gt_dir.mkdir()
    for i, (a, b) in enumerate(zip(images(3, 2), images(3, 3))):
        a.save(str(gen_dir / f"story{i}_{i + 1}.png"))
        if i < 2:
            b.save(str(gt_dir / f"story{i}_{i + 1}.png"))
        cap = salon / "Text" / "Caption" / ("Video" if i else "Bloom") / \
            f"story{i}"
        cap.mkdir(parents=True)
        (cap / f"{i + 1}.txt").write_text(PROMPTS[i] + "\n")
    got = ours.evaluate_directory(str(gen_dir), str(gt_dir), folder,
                                  str(salon), device="cpu")
    want = ref.evaluate_directory(str(gen_dir), str(gt_dir), folder,
                                  str(salon))
    assert sorted(got) == sorted(want) == ["clip_i", "clip_t"]
    for k in want:
        assert abs(got[k] - want[k]) <= REL * abs(want[k]), k
    for i in range(3):
        p = f"story{i}_{i + 1}.png"
        assert ours.resolve_caption_path(p, str(salon)) == \
            ref.resolve_caption_path(p, str(salon)) is not None
    assert ours.resolve_caption_path("nounderscore.png", str(salon)) is None


@pytest.mark.parametrize("edge,crop", [(32, 32), (24, 17)])
def test_preprocess_equals_clip_image_processor(tmp_path, edge, crop):
    import transformers
    proc = transformers.CLIPImageProcessor(
        size={"shortest_edge": edge}, crop_size=crop,
        image_mean=[0.5, 0.4, 0.3], image_std=[0.2, 0.3, 0.25])
    proc.save_pretrained(str(tmp_path))
    mine = ImageProcessor.from_folder(str(tmp_path))
    imgs = images(4, 5) + [images(1, 6)[0].convert("L"),
                           images(1, 7)[0].convert("RGBA")]
    want = proc(images=imgs, return_tensors="np")["pixel_values"]
    got = mine(imgs)
    assert got.dtype == np.float32 and got.shape == want.shape == (
        6, 3, crop, crop)
    assert np.abs(got - want).max() <= 1e-6
    # uint8 arrays too
    arrays = [np.asarray(im) for im in imgs[:4]]
    assert np.abs(mine(arrays) - want[:4]).max() <= 1e-6
    # a step turned off is not CLIPImageProcessor's default path: refused
    transformers.CLIPImageProcessor(do_center_crop=False).save_pretrained(
        str(tmp_path / "off"))
    with pytest.raises(ValueError, match="do_center_crop"):
        ImageProcessor.from_folder(str(tmp_path / "off"))


def test_frechet_distance_equals_jax(tmp_path):
    from storygen_tpu.evaluation import fid as ref
    rs = np.random.RandomState(0)
    a = rs.randn(64, 12)
    b = rs.randn(80, 12) * 1.3 + 0.2
    for got, want in (
            (ours_fid.fid_from_features(a, b), ref.fid_from_features(a, b)),
            (ours_fid.frechet_distance(*ours_fid.feature_statistics(a),
                                       *ours_fid.feature_statistics(b)),
             ref.frechet_distance(*ref.feature_statistics(a),
                                  *ref.feature_statistics(b)))):
        assert abs(got - want) <= 1e-8 * abs(want)
    np.testing.assert_allclose(ours_fid._sqrtm_psd(a.T @ a),
                               ref._sqrtm_psd(a.T @ a), rtol=1e-8, atol=0)
    # compute_fid over two folders with one feature_fn on both sides
    for name, seed in (("x", 8), ("y", 9)):
        (tmp_path / name).mkdir()
        for i, im in enumerate(images(5, seed)):
            im.save(str(tmp_path / name / f"{i}.png"))

    def feature_fn(batch):
        return np.concatenate([batch.reshape(len(batch), -1, 3).mean(1),
                               batch[:, ::8, ::8, 0].reshape(len(batch), -1)],
                              axis=1)

    got = ours_fid.compute_fid(str(tmp_path / "x"), str(tmp_path / "y"),
                               feature_fn, batch_size=2, size=16)
    want = ref.compute_fid(str(tmp_path / "x"), str(tmp_path / "y"),
                           feature_fn, batch_size=2, size=16)
    assert abs(got - want) <= 1e-8 * abs(want)
    with pytest.raises(ValueError, match="Inception"):
        ours_fid.compute_fid(str(tmp_path / "x"), str(tmp_path / "y"))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_text_tower_activation_equals_transformers(act):
    """The port's CLIPTextModel with `hidden_act` against transformers'
    CLIPTextModel on the same state dict; an unknown activation raises."""
    import transformers
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    kw = dict(num_hidden_layers=2, hidden_size=32, intermediate_size=64,
              num_attention_heads=4, hidden_act=act)
    torch.manual_seed(1)
    theirs = transformers.CLIPTextModel(transformers.CLIPTextConfig(**kw))
    mine = CLIPTextModel(CLIPTextConfig(**kw))
    sd = {k: v for k, v in theirs.state_dict().items()
          if not k.endswith("position_ids")}
    mine.load_state_dict(sd, strict=True)
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 49406, (2, 77)))
    with torch.no_grad():
        want = theirs(ids).last_hidden_state
        got = mine(ids)
    assert rel_l2(got, want) <= REL
    with pytest.raises(ValueError, match="hidden_act"):
        CLIPTextModel(CLIPTextConfig(**dict(kw, hidden_act="relu")))


def test_seeded_scorer_folder_loads_in_transformers(tmp_path, bpe):
    """The folder that run_quality.ensure_clip writes opens in
    transformers' CLIPModel / CLIPProcessor, whose features equal the
    port's."""
    import transformers
    from PIL import Image
    from storygen_tpu.evaluation import clip_scores as ref
    from storygen_tpu_torch.scripts import run_quality
    from tests.test_torch_port_quality import TINY_SCORER
    path = str(tmp_path / "scorer")
    run_quality.ensure_clip(path, bpe, TINY_SCORER)
    model = transformers.CLIPModel.from_pretrained(path)
    assert model.config.projection_dim == 16
    assert model.config.text_config.vocab_size == 49408
    proc = transformers.CLIPProcessor.from_pretrained(path)
    rs = np.random.RandomState(0)
    imgs = [Image.fromarray(rs.randint(0, 256, (40, 56, 3), np.uint8))
            for _ in range(3)]
    mine = ours.CLIPScorer(path, "cpu")
    with torch.no_grad():
        want = model.get_image_features(
            **proc(images=imgs, return_tensors="pt")).numpy()
        text = model.get_text_features(**proc(
            text=list(PROMPTS), return_tensors="pt", padding=True)).numpy()
    got = mine.image_features(imgs).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    got = mine.text_features(list(PROMPTS)).numpy()
    assert np.linalg.norm(got - text) <= 1e-5 * np.linalg.norm(text)
    theirs = ref.CLIPScorer(path)
    np.testing.assert_allclose(mine.text_embed(list(PROMPTS)),
                               theirs.text_embed(list(PROMPTS)), atol=1e-6)
