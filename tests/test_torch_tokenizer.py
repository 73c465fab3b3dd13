"""The port's BPE tokenizer (plain Python) vs the JAX package's (the
`tokenizers` package on the same vendored file).

Ids, attention masks and token_type_ids must be equal, id for id, on the
slice's navigation prompts, on seeded synthetic instructions with inline
specials, digits, punctuation, runs of spaces and newlines and non-ASCII
letters and numerals, and on every code point whose class the split regex
and Python's str methods read differently. Decoding must agree too.

    python tests/test_torch_tokenizer.py     # rewrites the golden fixture

writes tests/fixtures/bpe_nav_golden.json from the JAX tokenizer (the ids
chip_smoke.py holds the port to on the card, where `tokenizers` is absent).
"""
import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("tokenizers")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.prompts import navigation_prompt  # noqa: E402
from navillm_tpu_torch.models import tokenization as TT  # noqa: E402

GOLDEN = ROOT / "tests" / "fixtures" / "bpe_nav_golden.json"

_ATOMS = ["<hist>", "<cand>", "<cls_1>", "<cls_2>", "<obj>", "<s>", "</s>",
          "<PAD>", "<unk>", "<", ">", "</", "<hist", "hist>", " ", "  ",
          "    ", "\n", "\n\n", " \n", "\t", "\r\n", "　", " ",
          "'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'", " '",
          "walk", " the", "Turn", " kitchen", "stop", "(0)", "(12)", "3",
          " 42", "3.5", "²", "½", "一", "二十",
          "é", "naïve", "Ærø", "日本語",
          "\U0001f600", "ﬁ", "İ", "ß", "٣٤", ".",
          ",", "!", "?", "###", ":", "-", "—", "…", "_", "$"]


def _synthetic(seed: int, n: int):
    rng = random.Random(seed)
    return ["".join(rng.choice(_ATOMS) for _ in range(rng.randint(1, 30)))
            for _ in range(n)]


def _slice_prompts(tmp):
    """chip_smoke.py's world's instructions in navigation prompts at a
    spread of history and candidate counts, and the bare instructions."""
    anno = T.make_r2r_world(tmp, n_episodes=32)
    instrs = [x["instructions"][0] for x in json.loads(anno.read_text())]
    prompts = list(instrs)
    for i, ins in enumerate(instrs):
        for hist, cand in ((0, 1), (1, 5), (4, 13), (15, 13)):
            prompts.append(navigation_prompt("r2r", ins, (hist + i) % 16,
                                             cand, "<cls_1>"))
    return prompts


def golden_texts(tmp):
    """The fixture's texts: 8 slice prompts, 8 instructions, 16 synthetic
    strings and the U+001C..U+001F cases."""
    prompts = _slice_prompts(tmp)
    return (prompts[32:40] + prompts[:8] + _synthetic(7, 16)
            + ["a\x1cb", "x\x1d\x1e y", "\x1f\x1f", "x一y", "3²z"])


@pytest.fixture(scope="module")
def toks():
    return (JTok.bpe(max_length=1024, pad_to_multiple=64),
            TT.NavTokenizer.bpe(max_length=1024, pad_to_multiple=64))


def _assert_same_batch(jt, tt, texts):
    a, b = jt(texts), tt(texts)
    for name in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)


def test_json_copy_is_byte_for_byte():
    src = ROOT / "navillm_tpu" / "models" / "bpe_nav.json"
    dst = ROOT / "navillm_tpu_torch" / "models" / "bpe_nav.json"
    assert dst.read_bytes() == src.read_bytes()


def test_vocab_and_special_ids_match_jax(toks):
    jt, tt = toks
    for name in ("bos_id", "eos_id", "pad_id", "unk_id", "cand_id", "hist_id",
                 "obj_id", "cls_ids", "special_token_ids", "true_vocab_size",
                 "vocab_size"):
        assert getattr(tt, name) == getattr(jt, name), name
    np.testing.assert_array_equal(tt.special_logit_mask(),
                                  jt.special_logit_mask())


def test_slice_prompts_match_jax(toks, tmp_path):
    jt, tt = toks
    prompts = _slice_prompts(tmp_path)
    for p in prompts:
        assert tt.encode(p) == jt.encode(p), p
    for i in range(0, len(prompts), 16):
        _assert_same_batch(jt, tt, prompts[i:i + 16])
    # [prompt, answer] pairs: token_type_ids 1 on the answer
    _assert_same_batch(jt, tt, [[p, " (3) <cand> stop"] for p in prompts[:8]])


@pytest.mark.parametrize("seed", range(4))
def test_synthetic_instructions_match_jax(toks, seed):
    jt, tt = toks
    texts = _synthetic(seed, 100)
    for t in texts:
        assert tt.encode(t, add_bos=False) == jt.encode(t, add_bos=False), t
    _assert_same_batch(jt, tt, texts[:32])


@pytest.mark.parametrize("cp", [0x1c, 0x1d, 0x1e, 0x1f])
def test_separator_controls_split_as_punctuation(toks, cp):
    """str.isspace() holds for U+001C..U+001F, but the split regex's \\s
    does not match them: they split like punctuation."""
    jt, tt = toks
    c = chr(cp)
    assert TT.gpt2_split(f"a{c}b") == ["a", c, "b"]
    for text in (f"a{c}b", f"x {c}{c} y", f"{c}\n{c}", f"1{c}2 'd{c}"):
        assert tt.encode(text) == jt.encode(text), repr(text)


def test_split_classes():
    """Letters and numbers by Unicode category, not str.isalpha or
    str.isnumeric: U+4E00 is a letter (Lo), U+00B2 a number (No)."""
    assert TT.gpt2_split("x一y") == ["x一y"]
    assert TT.gpt2_split("3²z") == ["3²", "z"]
    # a whitespace run before a word leaves its last character to the next
    # piece; a lone one before a word is a piece of its own
    assert TT.gpt2_split("a  b\n\nc ") == ["a", " ", " b", "\n", "\n", "c",
                                           " "]
    assert TT.gpt2_split("it's 'S") == ["it", "'s", " '", "S"]


@pytest.mark.parametrize("skip", [True, False])
def test_decode_matches_jax(toks, skip):
    jt, tt = toks
    texts = _synthetic(11, 100)
    for t in texts:
        ids = jt.encode(t)
        assert tt.decode(ids, skip) == jt.decode(ids, skip), t
    rng = np.random.RandomState(5)
    for _ in range(300):    # arbitrary ids: partial UTF-8 sequences too
        ids = rng.randint(0, jt.true_vocab_size, rng.randint(1, 12)).tolist()
        assert tt.decode(ids, skip) == jt.decode(ids, skip), ids


def test_round_trip_on_instructions(toks, tmp_path):
    _, tt = toks
    for p in _slice_prompts(tmp_path)[:32]:
        assert tt.decode(tt.encode(p)) == p


def test_golden_fixture_matches_jax(toks, tmp_path):
    jt, tt = toks
    golden = json.loads(GOLDEN.read_text())
    assert golden["texts"] == golden_texts(tmp_path)
    assert golden["ids"] == [jt.encode(t) for t in golden["texts"]]
    assert golden["ids"] == [tt.encode(t) for t in golden["texts"]]


def test_bpe_prompts_are_shorter_than_bytes(toks, tmp_path):
    _, tt = toks
    byte = TT.NavTokenizer()
    prompts = _slice_prompts(tmp_path)[32:]
    ratio = (sum(len(byte.encode(p)) for p in prompts)
             / sum(len(tt.encode(p)) for p in prompts))
    assert ratio > 2.5, ratio


if __name__ == "__main__":
    import tempfile
    jt = JTok.bpe()
    with tempfile.TemporaryDirectory() as tmp:
        texts = golden_texts(tmp)
    GOLDEN.write_text(json.dumps(
        {"texts": texts, "ids": [jt.encode(t) for t in texts]},
        ensure_ascii=True) + "\n")
    print(f"wrote {GOLDEN}: {len(texts)} texts")
