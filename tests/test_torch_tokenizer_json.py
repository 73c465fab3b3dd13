"""Each part of a ``tokenizer.json`` that the port's ``TokenizerFile`` reads
(navillm_tpu_torch/models/tokenization.py, pretokenize.py, unigram.py),
against the ``tokenizers`` package on the same file.

Every case builds its tokenizer with ``tokenizers`` (the part set on one of
the committed fixtures' models), saves it, and runs the saved JSON through
both. Over hypothesis texts (derandomized) drawn to hold U+001C-U+001F,
U+0085, U+00A0, U+2028, U+3000, combining marks, long s and the Kelvin
sign, CJK, non-ASCII digits, runs of CR/LF and the added tokens next to
text, it holds the part's own output (the normalized string, the
pre-tokens) and the whole tokenizer's ids and decoding equal. Characters
are drawn from those Python 3.12's unicodedata (Unicode 15.0.0) assigns:
the port reads Unicode through it wherever it runs, and a character
assigned later is not in its tables (the Oniguruma in ``tokenizers``
knows Unicode 16). Parts outside the list raise, naming the part and the
file.
"""
import json
import string
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("tokenizers")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import (AddedToken, Regex, Tokenizer, decoders,  # noqa: E402
                        models, normalizers, pre_tokenizers)

from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.models import pretokenize as PT  # noqa: E402
from navillm_tpu_torch.models.tokenization import TokenizerFile  # noqa

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
BYTE_LEVEL = FIXTURES / "llama3_bpe" / "tokenizer.json"
SPM_BPE = FIXTURES / "spm_llama" / "tokenizer.json"
UNIGRAM = FIXTURES / "spm_unigram" / "tokenizer.json"
ADDED = ["<cand>", "<hist>", "<|eot_id|>"]

LLAMA3 = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
          r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
PATTERNS = {
    "llama3": LLAMA3,
    "qwen2": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "gpt4o": r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*"
             r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|"
             r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+"
             r"[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|"
             r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    "classes": r"\b\w+\b|[\p{P}\p{S}]|\h+|\d|\S",
    "properties": r"\p{Lu}\p{Ll}*|\P{L}+?|[\p{Nd}\p{No}]+|\p{Cc}",
    "anchors": r"^\s*\S+|\S+$|[一-龥぀-ゟ]+|\x{1F600}|\.{2,3}",
    "empty": r"\d*|x",
    "ignorecase": r"(?i)[a-z]+|k|s",
}

ATOMS = ["\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", " ", "　",
         "́", "̈", "̣", "ſ", "K", "K", "ß", "İ", "Σ",
         "ﬁ", "①", "¼", "²", "٣", "४", "日本", "語", "\r\n", "\r", "\n",
         "\n\n", "\t", " ", "  ", "'s", "'S", "'LL", "x'ſ", "é", "é",
         "가", "가", "ｶﾞ", "😀", "…", "—", ",", "!", "_", "12345",
         "don't", "Walk", " the", "Ⅷ", "Ⓐ", "\u200d", "🄰", "ǅ", "ﬅ", *ADDED]
TEXT = st.lists(st.one_of(
    st.sampled_from(ATOMS),
    st.characters(exclude_categories=("Cs", "Cn")),
    st.text(string.ascii_letters + string.digits + " .,'", max_size=6)),
    max_size=24).map("".join)
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None, suppress_health_check=list(HealthCheck))


def _pair(base, normalizer=False, pre_tokenizer=False, decoder=False,
          model=None):
    """(tokenizers' Tokenizer, the port's TokenizerFile) over one saved
    file: ``base``'s with the parts given (None clears one) and ADDED as
    added tokens (the first normalized, the others not)."""
    ref = Tokenizer.from_file(str(base))
    if model is not None:
        ref.model = model
    for name, part in (("normalizer", normalizer),
                       ("pre_tokenizer", pre_tokenizer),
                       ("decoder", decoder)):
        if part is not False:
            setattr(ref, name, part)
    ref.add_tokens([AddedToken(ADDED[0], normalized=True)])
    ref.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in ADDED[1:]])
    spec = json.loads(ref.to_str())
    return Tokenizer.from_str(json.dumps(spec)), TokenizerFile(spec)


def _same_ids(ref, port, text):
    want = ref.encode(text, add_special_tokens=False).ids
    assert port.encode(text) == want, text
    for skip in (True, False):
        assert port.decode(want, skip_special_tokens=skip) == \
            ref.decode(want, skip_special_tokens=skip), (text, skip)


# ---------------------------------------------------------- normalizers --- #
NORMALIZERS = {
    "NFC": normalizers.NFC(), "NFD": normalizers.NFD(),
    "NFKC": normalizers.NFKC(), "NFKD": normalizers.NFKD(),
    "Lowercase": normalizers.Lowercase(),
    "Strip": normalizers.Strip(), "StripLeft": normalizers.Strip(True, False),
    "StripRight": normalizers.Strip(False, True),
    "StripAccents": normalizers.StripAccents(),
    "ReplaceRegex": normalizers.Replace(Regex(r" {2,}|\p{Zs}"), "▁"),
    "ReplaceEmpty": normalizers.Replace(Regex(r"\d*"), "#"),
    "ReplaceString": normalizers.Replace("ab", "X"),
    "Prepend": normalizers.Prepend("▁"),
    "Sequence": normalizers.Sequence([
        normalizers.NFKD(), normalizers.StripAccents(),
        normalizers.Lowercase(), normalizers.Replace(Regex(r"\s+"), " "),
        normalizers.Strip()]),
}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
@SETTINGS
@given(text=TEXT)
def test_normalizer_matches_tokenizers(name, text):
    """The normalized string, then the ids and decoding of the byte-fallback
    BPE under it."""
    part = NORMALIZERS[name]
    ref, port = _pair(SPM_BPE, normalizer=part, pre_tokenizer=None)
    assert port._normalize(text, 0, None)[0] == part.normalize_str(text)
    _same_ids(ref, port, text)


# ------------------------------------------------------- pre-tokenizers --- #
def _seq(*parts):
    return pre_tokenizers.Sequence(list(parts))


PRE_TOKENIZERS = {
    **{f"Split[{k}]": (BYTE_LEVEL, _seq(
        pre_tokenizers.Split(Regex(p), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)))
       for k, p in PATTERNS.items()},
    **{f"Split[{b},{'inv' if inv else 'fwd'}]": (
        SPM_BPE, pre_tokenizers.Split(Regex(r"\p{P}+|\s"), b, invert=inv))
       for b in ("removed", "isolated", "merged_with_previous",
                 "merged_with_next", "contiguous") for inv in (False, True)},
    "Split[string]": (SPM_BPE, pre_tokenizers.Split(" ", "merged_with_next")),
    "ByteLevel[gpt2]": (BYTE_LEVEL, pre_tokenizers.ByteLevel(
        add_prefix_space=False)),
    "ByteLevel[no_regex]": (BYTE_LEVEL, pre_tokenizers.ByteLevel(
        add_prefix_space=False, use_regex=False)),
    "ByteLevel[prefix]": (BYTE_LEVEL, pre_tokenizers.ByteLevel(
        add_prefix_space=True)),
    "ByteLevel[prefix,split]": (BYTE_LEVEL, _seq(
        pre_tokenizers.WhitespaceSplit(),
        pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=False))),
    "Digits[individual]": (SPM_BPE, pre_tokenizers.Digits(True)),
    "Digits[runs]": (SPM_BPE, pre_tokenizers.Digits(False)),
    "Punctuation": (SPM_BPE, pre_tokenizers.Punctuation()),
    "Punctuation[next]": (SPM_BPE, pre_tokenizers.Punctuation(
        "merged_with_next")),
    "Whitespace": (SPM_BPE, pre_tokenizers.Whitespace()),
    "WhitespaceSplit": (SPM_BPE, pre_tokenizers.WhitespaceSplit()),
    **{f"Metaspace[{s},{sp}]": (SPM_BPE, pre_tokenizers.Metaspace(
        prepend_scheme=s, split=sp))
       for s in ("always", "first", "never") for sp in (True, False)},
    "Metaspace[first,after split]": (SPM_BPE, _seq(
        pre_tokenizers.Punctuation(), pre_tokenizers.Metaspace(
            prepend_scheme="first"))),
    "Sequence": (SPM_BPE, _seq(pre_tokenizers.WhitespaceSplit(),
                               pre_tokenizers.Digits(True),
                               pre_tokenizers.Punctuation())),
}


@pytest.mark.parametrize("name", sorted(PRE_TOKENIZERS))
@SETTINGS
@given(text=TEXT)
def test_pre_tokenizer_matches_tokenizers(name, text):
    """The pre-tokens, then the ids and decoding of the fixture's model
    under the pre-tokenizer."""
    base, part = PRE_TOKENIZERS[name]
    ref, port = _pair(base, normalizer=None, pre_tokenizer=part)
    want = [s for s, _ in part.pre_tokenize_str(text)]
    assert [p[0] for p in port._pre([(text, 0, None if not port._offsets
                                      else list(range(len(text))))])] \
        == want
    _same_ids(ref, port, text)


@pytest.mark.parametrize("scheme", ["always", "first", "never"])
@SETTINGS
@given(text=TEXT)
def test_metaspace_first_follows_offsets(scheme, text):
    """Metaspace after normalizers that move the text's first character
    (Strip, Prepend, a Replace at the start, NFKC): the replacement goes
    first where the library's offsets put a piece at the text's start."""
    norm = normalizers.Sequence([normalizers.Strip(), normalizers.NFKC(),
                                 normalizers.Replace(Regex(r"^\d"), "##")])
    ref, port = _pair(SPM_BPE, normalizer=norm, pre_tokenizer=_seq(
        pre_tokenizers.Digits(True), pre_tokenizers.Metaspace(
            prepend_scheme=scheme)))
    _same_ids(ref, port, text)


# ---------------------------------------------------- models and decoders --- #
def _unigram(byte_fallback: bool):
    vocab = [tuple(v) for v in json.loads(UNIGRAM.read_text())["model"]
             ["vocab"] if not (byte_fallback is False and v[0].startswith(
                 "<0x"))]
    return models.Unigram(vocab, 0, byte_fallback)


UNIGRAM_CASES = {
    "converted": dict(),
    "metaspace": dict(normalizer=None, pre_tokenizer=pre_tokenizers.Metaspace(
        prepend_scheme="always"), decoder=decoders.Metaspace(
            prepend_scheme="always")),
    "metaspace_first": dict(
        normalizer=None, pre_tokenizer=pre_tokenizers.Metaspace(
            prepend_scheme="first"), decoder=decoders.Metaspace(
            prepend_scheme="first")),
    "no_byte_fallback": dict(model=_unigram(False)),
    "spm_normalizer": dict(normalizer=normalizers.Sequence([
        normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "▁")]),
        pre_tokenizer=pre_tokenizers.Metaspace(),
        decoder=decoders.Metaspace()),
}


@pytest.mark.parametrize("name", sorted(UNIGRAM_CASES))
@SETTINGS
@given(text=TEXT)
def test_unigram_matches_tokenizers(name, text):
    """The Unigram model (ROADMAP A14): Viterbi over the pieces' scores,
    unknown characters at the lowest score less 10 and fused, byte
    fallback or unk_id."""
    ref, port = _pair(UNIGRAM, **UNIGRAM_CASES[name])
    _same_ids(ref, port, text)


DECODERS = {
    **{f"Metaspace[{s}]": decoders.Metaspace(replacement="▁",
                                             prepend_scheme=s)
       for s in ("always", "first", "never")},
    "Replace[regex]": decoders.Sequence([
        decoders.Replace(Regex(r"▁+|\d"), " "), decoders.ByteFallback(),
        decoders.Fuse()]),
}


@pytest.mark.parametrize("name", sorted(DECODERS))
@SETTINGS
@given(ids=st.lists(st.integers(0, 1100), max_size=12))
def test_decoder_matches_tokenizers(name, ids):
    ref, port = _pair(UNIGRAM, decoder=DECODERS[name])
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == \
            ref.decode(ids, skip_special_tokens=skip)


# ----------------------------------------------------------- LLaMA-3 --- #
@pytest.fixture(scope="module")
def llama3_pairs():
    """The committed fixture, and the card's generator grown to 20000
    entries, each as both packages read it."""
    base = json.loads(BYTE_LEVEL.read_text(encoding="utf-8"))
    out = {}
    for n in (None, 20000):
        spec = base if n is None else T.llama3_tokenizer_spec(base, n)
        out[n] = (Tokenizer.from_str(json.dumps(spec)), TokenizerFile(spec))
    return out


@SETTINGS
@given(text=TEXT)
def test_llama3_layout_matches_tokenizers(llama3_pairs, text):
    text = text.replace("<cand>", "<|begin_of_text|>")
    for ref, port in llama3_pairs.values():
        _same_ids(ref, port, text)


def test_llama3_generator(llama3_pairs):
    """llama3_tokenizer_spec: exactly n entries with a merge for each
    beyond the byte alphabet, the 256 special tokens right after them in
    LLaMA-3's order, the post-processor's bos with them; the layout's
    parts kept (the Split regex, ByteLevel without one, ignore_merges)."""
    ref, port = llama3_pairs[20000]
    spec = json.loads(ref.to_str())
    model = spec["model"]
    assert len(model["vocab"]) == 20000 == len(model["merges"]) + 256
    assert sorted(model["vocab"].values()) == list(range(20000))
    assert [(t["id"], t["content"]) for t in spec["added_tokens"]] == \
        list(enumerate(T.llama3_specials(), 20000))
    assert T.llama3_specials()[9] == "<|eot_id|>"
    assert model["ignore_merges"] and spec["pre_tokenizer"]["pretokenizers"][
        0]["pattern"]["Regex"] == LLAMA3
    bos = spec["post_processor"]["processors"][1]["special_tokens"]
    assert bos[T.LLAMA3_BOS]["ids"] == [20000]
    assert ref.encode("go").ids[0] == 20000 == port.token_to_id(T.LLAMA3_BOS)
    assert max(len(t) for t in model["vocab"]) <= T.LLAMA3_MAX_PIECE


def test_llama3_fixture_is_regenerated_byte_for_byte(tmp_path):
    """scripts/data_tools/make_llama3_fixture.py writes the committed
    fixture, byte for byte."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_llama3_fixture",
        ROOT / "scripts" / "data_tools" / "make_llama3_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.LLAMA3_PATTERN == LLAMA3
    out = mod.write_fixture(tmp_path / "llama3")
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (out / name).read_bytes() == \
            (FIXTURES / "llama3_bpe" / name).read_bytes(), name


# --------------------------------------------------------- translation --- #
def test_regex_classes_follow_oniguruma():
    """What Python's re reads otherwise: \\s without U+001C-U+001F, \\w
    with the marks, \\d on Decimal_Number only, the case-folded long s."""
    rx = PT.onig_to_re(LLAMA3)
    assert [m.group() for m in rx.finditer("a\x1cb c x'ſ y")] == \
        ["a", "\x1cb", " c", " x", "'ſ", " y"]
    assert PT.onig_to_re(r"\w+").fullmatch("éः")
    assert not PT.onig_to_re(r"\d").match("²")
    assert PT.onig_to_re(r"\s").match("\x85") and \
        not PT.onig_to_re(r"\s").match("\x1c")


UNREAD = {
    "possessive": ("pre_tokenizer", {"type": "Split", "pattern": {
        "Regex": r"\s++"}, "behavior": "Isolated", "invert": False},
        "possessive"),
    "atomic": ("pre_tokenizer", {"type": "Split", "pattern": {
        "Regex": r"(?>a|ab)c"}, "behavior": "Isolated", "invert": False},
        "the group"),
    "script": ("pre_tokenizer", {"type": "Split", "pattern": {
        "Regex": r"\p{Han}+"}, "behavior": "Isolated", "invert": False},
        "Han"),
    "G": ("normalizer", {"type": "Replace", "pattern": {"Regex": r"\Ga"},
                         "content": "b"}, r"\\G"),
    "posix": ("normalizer", {"type": "Replace", "pattern": {
        "Regex": "[[:alpha:]]"}, "content": "b"}, "POSIX"),
    "intersection": ("normalizer", {"type": "Replace", "pattern": {
        "Regex": "[a-z&&[^b]]"}, "content": "b"}, "intersection"),
    "midoption": ("normalizer", {"type": "Replace", "pattern": {
        "Regex": "a(?i)b"}, "content": "b"}, "option"),
    "Precompiled": ("normalizer", {"type": "Precompiled",
                                   "precompiled_charsmap": ""},
                    "normalizer Precompiled"),
    "BertNormalizer": ("normalizer", {"type": "BertNormalizer"},
                       "normalizer BertNormalizer"),
    "BertPreTokenizer": ("pre_tokenizer", {"type": "BertPreTokenizer"},
                         "pre-tokenizer BertPreTokenizer"),
    "UnicodeScripts": ("pre_tokenizer", {"type": "UnicodeScripts"},
                       "pre-tokenizer UnicodeScripts"),
    "WordPiece": ("decoder", {"type": "WordPiece", "prefix": "##",
                              "cleanup": True}, "decoder WordPiece"),
    "WordPieceModel": ("model", {"type": "WordPiece", "unk_token": "[UNK]",
                                 "vocab": {"[UNK]": 0}},
                       "model WordPiece"),
}


@pytest.mark.parametrize("name", sorted(UNREAD))
def test_unread_parts_raise(name):
    """A part outside the list raises ValueError naming it and the file."""
    field, part, match = UNREAD[name]
    spec = json.loads(SPM_BPE.read_text(encoding="utf-8"))
    spec[field] = part
    with pytest.raises(ValueError, match=match):
        TokenizerFile(spec, where="the/tokenizer.json")
    with pytest.raises(ValueError, match="the/tokenizer.json"):
        TokenizerFile(spec, where="the/tokenizer.json")
