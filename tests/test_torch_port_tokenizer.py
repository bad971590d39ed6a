"""The port's CLIP BPE tokenizer (storygen_tpu_torch/data/tokenizer.py)
against the JAX package's Tokenizer (transformers' CLIPTokenizerFast) on a
vocab.json / merges.txt pair that the test writes: equal (B, 77) int32 ids
on every string, a save_pretrained round trip that both read, and the pad
token from tokenizer_config.json / special_tokens_map.json."""
import json
import os
import shutil

import numpy as np
import pytest

from chip_smoke import write_bpe_files
from storygen_tpu.data.loader import Tokenizer as JaxTokenizer
from storygen_tpu_torch.data import tokenizer as T
from storygen_tpu_torch.data.tokenizer import Tokenizer

CORPUS = (
    "A little fox finds a glowing lantern in the snowy forest.",
    "The fox carries the lantern along a frozen river at dusk.",
    "It's the owl's den; they'll share what's left, won't they? I'd, "
    "we've, I'm",
    "Café naïve résumé Ærøskøbing ΟΔΟΣ straße 東京の夜 こんにちは 한국어",
    "123 4567 ½ ² ⅷ 3.14!!! ... ?!?  --> <== ''quoted''",
)
CASES = {
    "ascii": CORPUS[0],
    "contractions": "IT'S LOUD'S 'S 'sun '''s don't they'LL we'D",
    "digits": "in 1999 there were 12345 foxes, 3.14 of them",
    "punctuation_runs": "wait!!! what?!?... --> <== (((yes))) ''q''",
    "whitespace": "hello   world\n\n\tnew\r\nline  　 x\u0085y a b",
    "edges_of_whitespace": "  leading and trailing  ",
    "separators": "x\x1cy\x1dz",
    "accents": "Café naïve résumé Ærøskøbing straße éte",
    "greek_case": "ΟΔΟΣ Σ İstanbul ǅungla",
    "cjk": "東京の夜 こんにちは 한국어 🦊 fox 🏮",
    "numbers_unicode": "½ ² ⅷ Ⅻ ⑴ ٣ a1b2c3 x_y-z",
    "special_tokens": "x<|endoftext|>y <|startoftext|> <|ENDOFTEXT|>",
    "empty": "",
    "over_77": "the fox runs " * 40,
}


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clip_tok"))
    write_bpe_files(root, CORPUS, 300)
    return root


@pytest.mark.parametrize("name", sorted(CASES))
def test_ids_equal_the_jax_tokenizer(vocab_dir, name):
    ours = Tokenizer(vocab_dir)([CASES[name]])
    ref = JaxTokenizer(vocab_dir)([CASES[name]])
    assert ours.dtype == ref.dtype == np.int32
    assert ours.shape == (1, 77)
    np.testing.assert_array_equal(ours, ref)


def test_batch_layout(vocab_dir):
    """bos, at most 75 tokens, eos, then pad, row by row."""
    tok = Tokenizer(vocab_dir)
    texts = list(CASES.values())
    ids = tok(texts)
    np.testing.assert_array_equal(ids, JaxTokenizer(vocab_dir)(texts))
    assert (ids[:, 0] == 49406).all()
    long = ids[texts.index(CASES["over_77"])]
    assert long[-1] == 49407 and 49407 not in long[1:-1]
    np.testing.assert_array_equal(ids[texts.index("")][1:],
                                  np.full(76, 49407))
    assert len(tok.encode(CASES["over_77"])) > 75


def test_save_pretrained_round_trip(vocab_dir, tmp_path):
    tok = Tokenizer(vocab_dir)
    out = str(tmp_path / "saved")
    tok.save_pretrained(out)
    assert {"vocab.json", "merges.txt", "tokenizer_config.json",
            "special_tokens_map.json"} <= set(os.listdir(out))
    texts = list(CASES.values())
    want = tok(texts)
    np.testing.assert_array_equal(Tokenizer(out)(texts), want)
    np.testing.assert_array_equal(JaxTokenizer(out)(texts), want)


@pytest.mark.parametrize("config,smap,pad", [
    ({"pad_token": "!"}, None, "!"),
    ({"pad_token": {"__type": "AddedToken", "content": "!",
                    "lstrip": False, "normalized": True, "rstrip": False,
                    "single_word": False}}, None, "!"),
    (None, {"pad_token": "!"}, "!"),
    ({"pad_token": "!"}, {"pad_token": "<|endoftext|>"}, "<|endoftext|>"),
    (None, None, "<|endoftext|>"),
])
def test_pad_token_from_the_folder(vocab_dir, tmp_path, config, smap, pad):
    root = str(tmp_path / "tok")
    shutil.copytree(vocab_dir, root)
    for name, obj in (("tokenizer_config.json", config),
                      ("special_tokens_map.json", smap)):
        if obj is not None:
            with open(os.path.join(root, name), "w") as f:
                json.dump(obj, f)
    ours, ref = Tokenizer(root), JaxTokenizer(root)
    assert ours.special["pad_token"] == ref.tok.pad_token == pad
    texts = ["wow!! a fox", "hi ! there", "", CORPUS[1]]
    np.testing.assert_array_equal(ours(texts), ref(texts))


def test_words_follow_the_clip_pattern():
    assert T.words(T.normalize("It's  DON'T!!'s 12ab")) == [
        "it", "'s", "don", "'t", "!!'", "s", "1", "2", "ab"]
    assert T.normalize(" A\t\nB c ") == " a b c "
