"""LLaMA's sentencepiece ``tokenizer.model`` read by hand
(navillm_tpu_torch/models/sentencepiece.py) against protobuf and
transformers' slow-to-fast conversion.

The models are seeded (``testing.spm_pieces``: controls, byte pieces,
merged pieces at falling scores, the alphabet), written both by protobuf
and by ``testing.write_sentencepiece_model``. The reference for the spec
is ``LlamaConverter(...).converted()``, driven by
scripts/data_tools/make_spm_fixture.py's stub of a slow ``LlamaTokenizer``
and its protobuf extractor; this box has no ``sentencepiece``, and the
extractor's protobuf read of ``pieces[i].piece`` stands in for
sentencepiece's ``id_to_piece(i)`` and nothing else. JAX's
``NavTokenizer.from_pretrained`` (transformers.AutoTokenizer) reads the
converted ``tokenizer.json``; the port reads ``tokenizer.model`` alone.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.training import train_loop as JTL  # noqa: E402
from navillm_tpu.utils import config as JCFG  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import prompts as P  # noqa: E402
from navillm_tpu_torch.convert import flatten_tree  # noqa: E402
from navillm_tpu_torch.models import sentencepiece as S  # noqa: E402
from navillm_tpu_torch.models.tokenization import \
    NavTokenizer as TTok  # noqa: E402
from navillm_tpu_torch.models.tokenization import TokenizerFile  # noqa
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_spm_fixture", ROOT / "scripts/data_tools/make_spm_fixture.py")
MK = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MK)

torch.set_num_threads(1)
N_PIECES = 1500
USER_DEFINED = ("<img>", "[SEP]")
LAYOUTS = [(True, True), (True, False), (False, True), (False, False)]
PROMPTS = [
    P.navigation_prompt("r2r", "Walk past the sofa, then stop.", 3, 4,
                        "<cls_1>"),
    P.navigation_prompt("reverie", "Go to the café and bring me the "
                        "naïve chair.", 0, 2, "<cls_2>"),
    P.summarization_prompt("soon", "", 2, 3),
    "", " ", "go", " go", "  go", "go  ", "walk  forward   and turn left ",
    "line one\nline two\n\nthree\t tab\n", "\n leading newline",
    "the café is naïve — 日本語 text 😀 ok", "über Straße ☃",
    "<cand><hist><obj>", "a<cand>b", "<cand> <cand>  <cand>",
    "</s> and <s> and <unk> and <PAD>", "an <img> of [SEP] here",
    "Walk past the sofa, then stop. Which way? <cand> <cand>",
    "room 12345 and 3.14 or ²³", "x" * 40,
]


def _proto_model(pieces, model_type=2):
    """The same model as protobuf writes it (transformers' own
    sentencepiece_model_pb2)."""
    from transformers.convert_slow_tokenizer import import_protobuf
    m = import_protobuf().ModelProto()
    for p in pieces:
        sp = m.pieces.add()
        sp.piece, sp.score, sp.type = p.piece, p.score, p.type
    t = m.trainer_spec
    t.model_type, t.vocab_size, t.byte_fallback = model_type, len(pieces), \
        True
    t.unk_id, t.bos_id, t.eos_id, t.pad_id = 0, 1, 2, -1
    t.input.append("corpus.txt")
    t.character_coverage = 0.99995
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    return m.SerializeToString()


@pytest.fixture(scope="module")
def pieces():
    return T.spm_pieces(N_PIECES, seed=3, user_defined=USER_DEFINED)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory, pieces):
    path = tmp_path_factory.mktemp("spm") / "tokenizer.model"
    T.write_sentencepiece_model(path, pieces)
    return path


@pytest.mark.parametrize("writer", ["protobuf", "testing"])
def test_wire_reader_matches_protobuf(tmp_path, pieces, writer):
    """Every piece (string, score, type), the trainer spec's fields and the
    normalizer spec's, as protobuf parses them (defaults where absent),
    on a model written by protobuf and one written by the port's
    writer."""
    from transformers.convert_slow_tokenizer import import_protobuf
    data = _proto_model(pieces) if writer == "protobuf" else \
        T.write_sentencepiece_model(tmp_path / "m.model", pieces)
    want = import_protobuf().ModelProto()
    want.ParseFromString(data)
    got = S.parse_model(data)
    assert len(got.pieces) == len(want.pieces) == N_PIECES
    assert [(p.piece, p.score, p.type) for p in got.pieces] == \
        [(p.piece, p.score, p.type) for p in want.pieces]
    for spec, ref in ((got.trainer_spec, want.trainer_spec),
                      (got.normalizer_spec, want.normalizer_spec)):
        for name, value in spec.items():
            assert value == getattr(ref, name), name
    assert got.trainer_spec["pad_id"] == -1 and \
        got.trainer_spec["byte_fallback"]
    assert {p.type for p in got.pieces} == {S.UNKNOWN, S.CONTROL,
                                            S.USER_DEFINED, S.BYTE,
                                            S.NORMAL}


@pytest.mark.parametrize("legacy,add_prefix_space", LAYOUTS)
def test_spec_matches_llama_converter(model_file, legacy, add_prefix_space):
    """llama_tokenizer_spec is LlamaConverter's tokenizer.json field by
    field: the vocabulary, the merges in order, the normalizer, the
    pre-tokenizer, the decoder and the added tokens."""
    want = json.loads(MK.convert(model_file, legacy,
                                 add_prefix_space).to_str())
    got = S.llama_tokenizer_spec(S.load_model(model_file), legacy,
                                 add_prefix_space)
    assert sorted(got) == sorted(want)
    for key in want:
        if key != "model":
            assert got[key] == want[key], key
    for key in want["model"]:
        assert got["model"][key] == want["model"][key], key
    assert len(got["model"]["merges"]) > N_PIECES - 259 - len(T.SPM_ALPHABET)


def _directories(root, model_file, legacy, add_prefix_space):
    """(port, jax): the tokenizer.model alone beside its config, and the
    converted tokenizer.json beside the same config without
    add_prefix_space (a fast LlamaTokenizer given add_prefix_space
    converts from the slow one, which needs sentencepiece)."""
    conf = dict(MK.TOKENIZER_CONFIG, legacy=legacy,
                add_prefix_space=add_prefix_space)
    port, jax_dir = root / "model", root / "json"
    port.mkdir()
    jax_dir.mkdir()
    shutil.copy(model_file, port / "tokenizer.model")
    (port / "tokenizer_config.json").write_text(json.dumps(conf))
    MK.convert(model_file, legacy, add_prefix_space).save(
        str(jax_dir / "tokenizer.json"))
    del conf["add_prefix_space"]
    (jax_dir / "tokenizer_config.json").write_text(json.dumps(conf))
    return port, jax_dir


TOK_ATTRS = ("bos_id", "eos_id", "pad_id", "unk_id", "vocab_size",
             "true_vocab_size", "cand_id", "hist_id", "obj_id", "cls_ids",
             "special_token_ids", "bos_token", "eos_token")


@pytest.mark.parametrize("legacy,add_prefix_space", LAYOUTS)
def test_from_pretrained_matches_jax(tmp_path, model_file, legacy,
                                     add_prefix_space):
    """NavTokenizer.from_pretrained on the tokenizer.model directory equals
    JAX's on the converted tokenizer.json: the special ids, the vocabulary
    sizes, the ids of the schema prompts and of text with leading, double
    and trailing spaces, newlines and characters only the byte pieces
    cover, the batches, and decoding (any id sequence too)."""
    port, jax_dir = _directories(tmp_path, model_file, legacy,
                                 add_prefix_space)
    kw = dict(max_length=96, pad_to_multiple=32)
    tt, jt = TTok.from_pretrained(str(port), **kw), \
        JTok.from_pretrained(str(jax_dir), **kw)
    for a in TOK_ATTRS:
        assert getattr(tt, a) == getattr(jt, a), a
    assert tt.true_vocab_size == N_PIECES + 6
    byte_ids = set(range(3 + len(USER_DEFINED), 259 + len(USER_DEFINED)))
    fell_back = False
    for text in PROMPTS:
        ids = jt.encode(text, add_bos=False)
        assert tt.encode(text, add_bos=False) == ids, text
        fell_back |= bool(byte_ids & set(ids))
        for skip in (True, False):
            assert tt.decode(ids, skip_special_tokens=skip) == \
                jt.decode(ids, skip_special_tokens=skip), (text, skip)
    assert fell_back
    texts = [PROMPTS[0], (PROMPTS[5], "a chair"), PROMPTS[12], ("", "x")]
    tb, jb = tt(texts), jt(texts)
    for f in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
    rng = np.random.RandomState(0)
    for _ in range(200):
        ids = rng.randint(0, tt.true_vocab_size, rng.randint(0, 12)).tolist()
        for skip in (True, False):
            assert tt.decode(ids, skip_special_tokens=skip) == \
                jt.decode(ids, skip_special_tokens=skip), ids


def test_spec_runs_as_its_file(tmp_path, model_file):
    """TokenizerFile over the spec dict encodes and decodes as over the
    same spec saved as tokenizer.json."""
    spec = S.llama_tokenizer_spec(S.load_model(model_file))
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    a, b = TokenizerFile(spec), TokenizerFile(tmp_path / "tokenizer.json")
    for text in PROMPTS:
        ids = a.encode(text)
        assert ids == b.encode(text) and a.decode(ids) == b.decode(ids)


def test_build_runner_matches_jax(tmp_path):
    """build_runner on a tiny Llama checkpoint whose directory holds only
    tokenizer.model (the committed fixture's model) equals JAX's over the
    tokenizer.json twin: the configuration, the tree's keys and shapes, the
    loaded LLM bit for bit and the tokenizer's ids."""
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM
    hf = LlamaForCausalLM(HFConfig(
        vocab_size=MK.N_PIECES, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rms_norm_eps=1e-6)).eval()
    dirs = {}
    for name, files in (("model", ("tokenizer.model",)),
                        ("json", ("tokenizer.json",))):
        d = dirs[name] = tmp_path / name
        hf.save_pretrained(d, safe_serialization=True)
        for f in files + ("tokenizer_config.json",):
            shutil.copy(MK.FIXTURE / f, d / f)
    kw = dict(seed=0, image_feat_size=32, obj_feat_size=16,
              precision="fp32")
    jr = JTL.build_runner(JCFG.TrainArgs(
        pretrained_model_name_or_path=str(dirs["json"]), **kw), None)
    tr = TTL.build_runner(TCFG.TrainArgs(
        pretrained_model_name_or_path=str(dirs["model"]), device="cpu",
        **kw), None)
    assert tr.cfg.llm.vocab_size == jr.cfg.llm.vocab_size == 1024
    got = {n: p.detach().numpy() for n, p in tr.model.named_parameters()}
    want = flatten_tree(jax.tree.map(np.asarray, jr.params))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        if n.startswith("llm."):
            np.testing.assert_array_equal(got[n], w, err_msg=n)
    for a in TOK_ATTRS:
        assert getattr(tr.tok, a) == getattr(jr.tok, a), a
    for text in PROMPTS:
        assert tr.tok.encode(text) == jr.tok.encode(text), text


def test_fixture_is_regenerated_byte_for_byte(tmp_path):
    """scripts/data_tools/make_spm_fixture.py writes the committed fixture:
    the seeded tokenizer.model, transformers' conversion of it and the
    config, byte for byte."""
    out = MK.write_fixture(tmp_path / "spm")
    names = sorted(p.name for p in MK.FIXTURE.iterdir())
    assert names == sorted(p.name for p in out.iterdir()) == [
        "tokenizer.json", "tokenizer.model", "tokenizer_config.json"]
    for name in names:
        assert (out / name).read_bytes() == (MK.FIXTURE / name).read_bytes(), \
            name
    assert len(S.load_model(out / "tokenizer.model").pieces) == MK.N_PIECES


def test_unigram_and_other_classes_raise(tmp_path, pieces):
    """A word model raises naming its file, through the spec and through
    from_pretrained, where a Unigram model (ROADMAP A14, closed) now
    converts; so does a tokenizer.model of another tokenizer class (a T5
    one), and a file that is no sentencepiece model."""
    d = tmp_path / "unigram"
    d.mkdir()
    (d / "tokenizer.model").write_bytes(_proto_model(pieces, model_type=1))
    assert S.llama_tokenizer_spec(S.load_model(d / "tokenizer.model"))[
        "model"]["type"] == "Unigram"
    assert TTok.from_pretrained(str(d)).true_vocab_size == N_PIECES + 6
    (d / "tokenizer.model").write_bytes(_proto_model(pieces, model_type=3))
    with pytest.raises(ValueError, match="word"):
        S.llama_tokenizer_spec(S.load_model(d / "tokenizer.model"))
    with pytest.raises(ValueError, match=f"{d}.*word"):
        TTok.from_pretrained(str(d))
    d = tmp_path / "t5"
    d.mkdir()
    shutil.copy(MK.FIXTURE / "tokenizer.model", d / "tokenizer.model")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5Tokenizer"}))
    with pytest.raises(ValueError, match="T5Tokenizer"):
        TTok.from_pretrained(str(d))
    (d / "tokenizer_config.json").unlink()
    assert TTok.from_pretrained(str(d)).true_vocab_size == MK.N_PIECES + 6
    (d / "tokenizer.model").write_bytes(b"\x0a\xff")
    with pytest.raises(ValueError, match="not a sentencepiece model"):
        TTok.from_pretrained(str(d))


# ------------------------------------------------- Unigram (ROADMAP A14) --- #
@pytest.fixture(scope="module")
def unigram_file(tmp_path_factory, pieces):
    path = tmp_path_factory.mktemp("spm_unigram") / "tokenizer.model"
    T.write_sentencepiece_model(path, pieces, model_type=1)
    return path


@pytest.mark.parametrize("legacy,add_prefix_space", LAYOUTS)
def test_unigram_spec_matches_llama_converter(unigram_file, legacy,
                                              add_prefix_space):
    """A Unigram tokenizer.model: llama_tokenizer_spec is LlamaConverter's
    tokenizer.json field by field (SpmConverter.tokenizer's Unigram model:
    the scored pieces, unk_id 0, byte fallback; the same normalizer,
    pre-tokenizer, decoder and added tokens as for BPE)."""
    want = json.loads(MK.convert(unigram_file, legacy,
                                 add_prefix_space).to_str())
    got = S.llama_tokenizer_spec(S.load_model(unigram_file), legacy,
                                 add_prefix_space)
    assert want["model"]["type"] == "Unigram"
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("legacy,add_prefix_space", LAYOUTS)
def test_unigram_from_pretrained_matches_jax(tmp_path, unigram_file, legacy,
                                            add_prefix_space):
    """NavTokenizer.from_pretrained on the Unigram tokenizer.model directory
    equals JAX's on the converted tokenizer.json (tokenizers runs its
    Unigram model): the special ids and sizes, the ids of every prompt (the
    byte pieces taken for characters the pieces lack), and decoding."""
    port, jax_dir = _directories(tmp_path, unigram_file, legacy,
                                 add_prefix_space)
    kw = dict(max_length=96, pad_to_multiple=32)
    tt, jt = TTok.from_pretrained(str(port), **kw), \
        JTok.from_pretrained(str(jax_dir), **kw)
    for a in TOK_ATTRS:
        assert getattr(tt, a) == getattr(jt, a), a
    byte_ids = set(range(3 + len(USER_DEFINED), 259 + len(USER_DEFINED)))
    fell_back = False
    for text in PROMPTS:
        ids = jt.encode(text, add_bos=False)
        assert tt.encode(text, add_bos=False) == ids, text
        fell_back |= bool(byte_ids & set(ids))
        for skip in (True, False):
            assert tt.decode(ids, skip_special_tokens=skip) == \
                jt.decode(ids, skip_special_tokens=skip), (text, skip)
    assert fell_back


def test_unigram_fixture_is_regenerated_byte_for_byte(tmp_path):
    """make_spm_fixture.py writes the committed Unigram fixture (the seeded
    pieces in a Unigram tokenizer.model, transformers' conversion of it and
    the config) byte for byte; the port's spec of its model is the
    converted file."""
    out = MK.write_fixture(tmp_path / "unigram", model_type=1)
    names = sorted(p.name for p in MK.UNIGRAM_FIXTURE.iterdir())
    assert names == sorted(p.name for p in out.iterdir()) == [
        "tokenizer.json", "tokenizer.model", "tokenizer_config.json"]
    for name in names:
        assert (out / name).read_bytes() == \
            (MK.UNIGRAM_FIXTURE / name).read_bytes(), name
    spec = S.llama_tokenizer_spec(S.load_model(out / "tokenizer.model"))
    assert spec == json.loads((out / "tokenizer.json").read_text(
        encoding="utf-8"))
