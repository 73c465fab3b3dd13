"""The port's pretrained path against the JAX package's: HF-layout Llama
weights (sharded safetensors, .bin, tied embeddings) read without
transformers or safetensors, the fast-tokenizer directory read without
tokenizers, int8/int4 loading, build_runner's pretrained, from-scratch and
resume branches, and whole runs from the checkpoint.

The fixtures are written here with transformers and tokenizers (this box
has them; the port's modules import neither): a tiny LlamaForCausalLM
(3 layers, hidden 64, GQA 4/2, vocabulary 1016) saved force-sharded as
tests/test_convert.py does, and tokenizer directories in three layouts.
Trees and ids are held exactly; logits as tests/test_convert.py and
tests/test_torch_nav_model.py hold them.
"""
import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.feature_db import \
    SyntheticImageFeaturesDB as JFeatures  # noqa: E402
from navillm_tpu.models import convert as JCV  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models import quant as JQ  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa
from navillm_tpu.sim import WorldModel as JWorld  # noqa: E402
from navillm_tpu.testing import synthetic_nav_batch  # noqa: E402
from navillm_tpu.training import train_loop as JTL  # noqa: E402
from navillm_tpu.utils import config as JCFG  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents import prompts as P  # noqa: E402
from navillm_tpu_torch.agents.runner import (NavModelRunner,  # noqa: E402
                                             RolloutDims)
from navillm_tpu_torch.convert import flatten_tree, params_from_jax  # noqa
from navillm_tpu_torch.data.feature_db import \
    SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu_torch.models import convert as TCV  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models import quant as TQ  # noqa: E402
from navillm_tpu_torch.models.tokenization import \
    NavTokenizer as TTok  # noqa: E402
from navillm_tpu_torch.sim import WorldModel  # noqa: E402
from navillm_tpu_torch.training import checkpoints as TC  # noqa: E402
from navillm_tpu_torch.training import train_loop as TTL  # noqa: E402
from navillm_tpu_torch.utils import config as TCFG  # noqa: E402

torch.set_num_threads(1)
BPE_NAV = os.path.join(os.path.dirname(TCV.__file__), "bpe_nav.json")
VOCAB = 1016            # bpe_nav.json's; the tokenizer's table is 1024
TOL = dict(rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ fixtures --- #
def _tokenizer_files(d, pad=True):
    shutil.copy(BPE_NAV, d / "tokenizer.json")
    conf = {"tokenizer_class": "PreTrainedTokenizerFast",
            "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
            "clean_up_tokenization_spaces": False}
    if pad:
        conf["pad_token"] = "<PAD>"
    (d / "tokenizer_config.json").write_text(json.dumps(conf))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """{layout: directory} of one tiny Llama: "st" (safetensors, 150 KB
    shards), "bin" (pytorch_model*.bin, sharded) and "tied" (safetensors,
    tied embeddings, its own weights), each with the bpe_nav tokenizer."""
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM
    root = tmp_path_factory.mktemp("vicuna_tiny")
    out = {}
    for name, tied in (("st", False), ("bin", False), ("tied", True)):
        hf_cfg = HFConfig(vocab_size=VOCAB, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=3,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=2048, rms_norm_eps=1e-6,
                          tie_word_embeddings=tied)
        torch.manual_seed(0 if name != "tied" else 1)
        hf = LlamaForCausalLM(hf_cfg).eval()
        d = root / name
        hf.save_pretrained(d, safe_serialization=name != "bin",
                           max_shard_size="150KB")
        _tokenizer_files(d)
        out[name] = d
        out[name + "_model"] = hf
    return out


def _np(x):
    """A leaf of either package as numpy, bf16 as its f32 value."""
    if torch.is_tensor(x):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _dtype_name(x):
    """torch.bfloat16 / np.dtype(bfloat16) -> "bfloat16"."""
    if torch.is_tensor(x):
        return str(x.dtype).split(".")[-1]
    return np.asarray(x).dtype.name


def _assert_same_tree(got, want, what=""):
    """Port tree == JAX tree: keys, shapes, dtypes and every bit."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert tuple(g.shape) == tuple(np.shape(w)), (what, k)
        assert _dtype_name(g) == _dtype_name(w), (what, k)
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{what} {k}")


def _jdtype(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


# -------------------------------------------------------------- loader --- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_loader_matches_jax(ckpt, dtype):
    d = ckpt["st"]
    shards = [f for f in os.listdir(d) if f.endswith(".safetensors")]
    assert len(shards) > 1 and (d / "model.safetensors.index.json").exists()
    tcfg, tp = TCV.load_vicuna_streaming(d, 1024, dtype=dtype, device="cpu")
    jcfg, jp = JCV.load_vicuna_streaming(str(d), 1024, dtype=_jdtype(dtype))
    assert dataclasses.asdict(tcfg) == {
        **{k: v for k, v in dataclasses.asdict(jcfg).items()
           if k != "dtype"}, "dtype": dtype, "q4_impl": "auto"}
    assert (tcfg.num_kv_heads, tcfg.vocab_size) == (2, 1024)
    _assert_same_tree(tp, jp, "streaming")
    # the 8 extension rows are the numpy-f32 mean of the checkpoint's rows
    src = ckpt["st_model"].model.embed_tokens.weight.detach().numpy()
    mean = src.mean(axis=0)
    for row in _np(tp["embed"])[VOCAB:]:
        np.testing.assert_array_equal(
            row, torch.from_numpy(mean).to(dtype).float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bin_loader_matches_jax(ckpt, dtype):
    """pytorch_model-*.bin under its index, through torch.load(mmap) on the
    port's side and from_pretrained + convert_hf_llama on JAX's."""
    d = ckpt["bin"]
    assert (d / "pytorch_model.bin.index.json").exists()
    assert not any(f.endswith(".safetensors") for f in os.listdir(d))
    _, tp = TCV.load_vicuna(d, 1024, dtype=dtype, device="cpu")
    _, jp = JCV.load_vicuna(str(d), 1024, dtype=_jdtype(dtype))
    _assert_same_tree(tp, jp, "bin")
    # the same weights as the safetensors save of the same model
    _, sp = TCV.load_vicuna(ckpt["st"], 1024, dtype=dtype, device="cpu")
    for k, v in flatten_tree(sp).items():
        assert torch.equal(flatten_tree(tp)[k], v), k


def test_tied_embeddings_match_jax(ckpt):
    d = ckpt["tied"]
    index = json.loads((d / "model.safetensors.index.json").read_text())
    assert "lm_head.weight" not in index["weight_map"]
    _, tp = TCV.load_vicuna(d, 1024, dtype=torch.float32, device="cpu")
    _, jp = JCV.load_vicuna_streaming(str(d), 1024, dtype=jnp.float32)
    _assert_same_tree(tp, jp, "tied")
    assert torch.equal(tp["lm_head"], tp["embed"].t())


def test_missing_shard_raises(ckpt, tmp_path):
    d = tmp_path / "partial"
    shutil.copytree(ckpt["st"], d)
    shard = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))[1]
    (d / shard).unlink()
    with pytest.raises(ValueError, match="incomplete"):
        TCV.load_vicuna(d, 1024, device="cpu")
    with pytest.raises(ValueError, match="incomplete"):
        JCV.load_vicuna_streaming(str(d), 1024)


def test_logits_match_hf(ckpt):
    """The port's LLM on the loaded f32 tree against HF's logits, within
    tests/test_convert.py's 2e-4."""
    hf = ckpt["st_model"]
    cfg, p = TCV.load_vicuna(ckpt["st"], 1024, dtype=torch.float32,
                             device="cpu")
    cfg = dataclasses.replace(cfg, attn_impl="eager", remat=False)
    ids = np.array([[1, 5, 9, 200, 77, 3, 1010, 640]], np.int64)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids)).logits.numpy()
        mask = torch.ones(ids.shape, dtype=torch.bool)
        hidden = TL.forward_hidden(p, cfg, TL.embed_with_injection(
            p, torch.from_numpy(ids)), mask)
        got = TL.logits_from_hidden(p, cfg, hidden).numpy()
    assert got.shape == (1, 8, 1024)
    np.testing.assert_allclose(got[..., :VOCAB], ref, rtol=2e-4, atol=2e-4)


def test_safetensors_reader_and_writer(tmp_path):
    """Every dtype the reader takes, written by the safetensors package and
    read back bit for bit; the port's writer read by that package; a dtype
    it does not take raises."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5), generator=g)
    tensors = {"bf16": x.bfloat16(), "f16": x.half(), "f32": x,
               "f64": x.double(), "i64": (x * 100).long(),
               "i32": (x * 100).int(), "i16": (x * 100).short(),
               "i8": (x * 10).to(torch.int8), "u8": (x.abs() * 10).byte(),
               "bool": x > 0, "empty": torch.zeros((0, 4)),
               "scalar": torch.tensor(2.5)}
    save_file(tensors, str(tmp_path / "a.safetensors"),
              metadata={"format": "pt"})
    with TCV.SafetensorsFile(tmp_path / "a.safetensors") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and got.shape == t.shape, k
            assert torch.equal(got, t), k
    TCV.save_safetensors(tensors, tmp_path / "b.safetensors",
                         metadata={"format": "pt"})
    back = load_file(str(tmp_path / "b.safetensors"))
    assert sorted(back) == sorted(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    save_file({"w": torch.zeros(2, dtype=torch.float8_e4m3fn)},
              str(tmp_path / "c.safetensors"))
    with TCV.SafetensorsFile(tmp_path / "c.safetensors") as f:
        with pytest.raises(ValueError, match="F8_E4M3"):
            f.get_tensor("w")


def test_save_vicuna_round_trips_through_jax(ckpt, tmp_path):
    """The port's writer (used by chip_smoke.py's phase 33): the loaded
    tree written back with its vocabulary cut to the checkpoint's rows,
    then read by JAX's loader (the safetensors package) and the port's:
    both give the tree it came from, the extension rows re-made from the
    written (bf16) rows."""
    cfg, p = TCV.load_vicuna(ckpt["st"], 1024, dtype=torch.bfloat16,
                             device="cpu")
    index = TCV.save_vicuna(tmp_path / "w", p, cfg, vocab_rows=VOCAB,
                            shard_bytes=100_000)
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 2 and shards[0] == \
        f"model-00001-of-{len(shards):05d}.safetensors"
    _, back = TCV.load_vicuna(tmp_path / "w", 1024, dtype=torch.bfloat16,
                              device="cpu")
    _, jback = JCV.load_vicuna_streaming(str(tmp_path / "w"), 1024,
                                         dtype=jnp.bfloat16)
    _assert_same_tree(back, jback, "jax reads the port's writer")
    back = flatten_tree(back)
    for k, v in flatten_tree(p).items():
        if k == "embed":
            back[k], v = back[k][:VOCAB], v[:VOCAB]
        elif k == "lm_head":
            back[k], v = back[k][:, :VOCAB], v[:, :VOCAB]
        assert torch.equal(back[k], v), k


def test_resize_rows_matches_jax():
    rng = np.random.RandomState(3)
    table = rng.randn(37, 24).astype(np.float32)
    for rows in (37, 40, 128, 30):
        want = JCV._resize_rows(table, rows)
        got = TCV._resize_rows(torch.from_numpy(table), rows)
        np.testing.assert_array_equal(got.numpy(), want)
    t16 = torch.from_numpy(table).bfloat16()
    want = JCV._resize_rows(t16.float().numpy(), 64)
    np.testing.assert_array_equal(
        TCV._resize_rows(t16, 64, dtype=torch.float32).numpy(), want)


# ----------------------------------------------------------- tokenizer --- #
TRAIN_TEXT = [
    "walk forward and turn left at the stairs",
    "go to the kitchen past the red chair",
    "stop near the table by the window",
    "which direction should we go to reach the goal",
    "navigation instruction history candidate object",
] * 4

CORPUS = [
    "", "go", " go", "  go", "walk forward and turn left at the stairs",
    "go to <cand> then <cand> with <hist> memory", "<cand><hist><obj>",
    "<cls_1> start", "end <cls_2>", "a<cand>b", "<cand> <cand>  <cand>",
    "the café is naïve — 日本語 text 😀 ok", "room 12345 and 3.14 or ²³",
    "runs   of    spaces", "line one\nline two\n\nthree\t tab",
    "</s> and <s> and <unk> and <PAD>", "über Straße", "x" * 40,
    "Walk past the sofa, then stop. Which way? <cand> <cand>",
]


TEMPLATES = [
    *(P.navigation_prompt(t, "Walk past the sofa, then stop. Isn't it "
                          "the café's door?", h, c, cls)
      for t in ("r2r", "reverie", "cvdn", "eqa")
      for h, c, cls in ((0, 1, "<cls_1>"), (4, 13, "<cls_2>"))),
    P.summarization_prompt("reverie", "", 3, 4),
    P.embodied_qa_prompt("eqa", "what color is the sofa?", 2, 5),
    P.object_grounding_prompt("reverie", "Find the lamp.", 2, 6, "<cls_1>"),
]
LLAMA3_FIXTURE = Path(__file__).resolve().parent / "fixtures" / "llama3_bpe"


def _whitespace_layout(d):
    """tests/test_hf_tokenizer.py:20-44's tokenizer."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(TRAIN_TEXT, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>", "<s>", "</s>"]))
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
        "model_max_length": 4096, "clean_up_tokenization_spaces": False}))


def _llama_layout(d, metaspace):
    """Llama's fast-tokenizer layout: a byte-fallback BPE whose vocabulary
    holds the 256 <0xNN> tokens as ordinary entries, under the legacy
    Prepend/Replace normalizer or a Metaspace(prepend_scheme="first")
    pre-tokenizer, with the Replace/ByteFallback/Fuse/Strip decoder."""
    from tokenizers import (AddedToken, Tokenizer, decoders, models,
                            normalizers, pre_tokenizers, trainers)

    def shaped(tok):
        if metaspace:
            tok.pre_tokenizer = pre_tokenizers.Metaspace(
                replacement="▁", prepend_scheme="first")
        else:
            tok.normalizer = normalizers.Sequence([
                normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
        return tok
    base = shaped(Tokenizer(models.BPE(unk_token="<unk>")))
    base.train_from_iterator(TRAIN_TEXT, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"]))
    spec = json.loads(base.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for t, _ in sorted(spec["vocab"].items(), key=lambda x: x[1]):
        vocab.setdefault(t, len(vocab))
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
              for m in spec["merges"]]
    tok = shaped(Tokenizer(models.BPE(vocab=vocab, merges=merges,
                                      unk_token="<unk>", byte_fallback=True,
                                      fuse_unk=True)))
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in ("<unk>", "<s>", "</s>")])
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>", "legacy": True,
        "add_bos_token": True, "clean_up_tokenization_spaces": False,
        "model_max_length": 4096}))


def _llama3_layout(d):
    """LLaMA-3's layout (tests/fixtures/llama3_bpe): the Split regex then
    ByteLevel without one, ignore_merges, 256 special tokens after the
    vocabulary, no unk or pad token."""
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(LLAMA3_FIXTURE / f, d / f)


def _unigram_layout(d):
    """A Unigram model trained by tokenizers' UnigramTrainer, with the
    Metaspace pre-tokenizer and decoder."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)
    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(TRAIN_TEXT, trainers.UnigramTrainer(
        vocab_size=120, special_tokens=["<unk>", "<s>", "</s>"],
        unk_token="<unk>", show_progress=False))
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
        "clean_up_tokenization_spaces": False}))


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    out = {}
    for name, make in (("whitespace", _whitespace_layout),
                       ("llama", lambda d: _llama_layout(d, False)),
                       ("metaspace", lambda d: _llama_layout(d, True)),
                       ("bpe_nav", _tokenizer_files),
                       ("bpe_nav_no_pad",
                        lambda d: _tokenizer_files(d, pad=False)),
                       ("llama3", _llama3_layout),
                       ("unigram", _unigram_layout)):
        d = root / name
        d.mkdir()
        make(d)
        out[name] = d
    return out


TOK_ATTRS = ("bos_id", "eos_id", "pad_id", "unk_id", "vocab_size",
             "true_vocab_size", "cand_id", "hist_id", "obj_id", "cls_ids",
             "special_token_ids", "bos_token", "eos_token")


@pytest.mark.parametrize("layout", ["whitespace", "llama", "metaspace",
                                    "bpe_nav", "bpe_nav_no_pad", "llama3",
                                    "unigram"])
def test_tokenizer_matches_hf(tok_dirs, layout):
    """NavTokenizer.from_pretrained on both sides (JAX's through
    transformers.AutoTokenizer): the ids, the specials and the vocabulary
    sizes, every text of CORPUS and every R2R, REVERIE, CVDN and EQA
    prompt template, the batches and decoding."""
    d = str(tok_dirs[layout])
    kw = dict(max_length=24, pad_to_multiple=16)
    jt, tt = JTok.from_pretrained(d, **kw), TTok.from_pretrained(d, **kw)
    for a in TOK_ATTRS:
        assert getattr(tt, a) == getattr(jt, a), a
    for text in CORPUS + TEMPLATES:
        ids = jt.encode(text, add_bos=False)
        assert tt.encode(text, add_bos=False) == ids, text
        for skip in (True, False):
            assert tt.decode(ids, skip_special_tokens=skip) == \
                jt.decode(ids, skip_special_tokens=skip), (text, skip)
    texts = [CORPUS[5], ("what is it <cand>", "a chair"), CORPUS[11],
             "walk " * 30, ("", "x")]
    jb, tb = jt(texts), tt(texts)
    for f in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
    assert tb.input_ids.shape[1] == 24          # truncated on the left
    np.testing.assert_array_equal(tt.special_logit_mask(),
                                  jt.special_logit_mask())
    # any id sequence decodes alike (invalid UTF-8 byte runs included)
    rng = np.random.RandomState(0)
    for _ in range(200):
        ids = rng.randint(0, tt.true_vocab_size, rng.randint(0, 12)).tolist()
        for skip in (True, False):
            assert tt.decode(ids, skip_special_tokens=skip) == \
                jt.decode(ids, skip_special_tokens=skip), ids


def test_tokenizer_layouts_differ_where_hf_does(tok_dirs):
    """The two Llama pre-processings part exactly where HF's do: the legacy
    normalizer gives every segment between specials its own "▁", Metaspace
    "first" only the one at the start of the text; non-ASCII falls back to
    <0xNN> bytes, which stay ordinary (decoded, never skipped)."""
    leg = TTok.from_pretrained(str(tok_dirs["llama"])).backend.tok
    meta = TTok.from_pretrained(str(tok_dirs["metaspace"])).backend.tok

    def pieces(t, text):
        return [t._id_to_token[i] for i in t.encode(text)]
    def after(t, text):
        p = pieces(t, text)
        return p[p.index("<cand>") + 1]
    assert after(leg, "go<cand>go").startswith("▁")
    assert not after(meta, "go<cand>go").startswith("▁")
    assert pieces(meta, "go<cand>go")[0].startswith("▁")
    assert not pieces(meta, "<cand>go")[1].startswith("▁")
    assert "<0xC3>" in pieces(leg, "é") and "<0xC3>" in pieces(meta, "é")
    ids = leg.encode("é")
    assert leg.decode(ids, skip_special_tokens=True) == "é"


# -------------------------------------------------------- quantization --- #
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_load_matches_jax(ckpt, bits):
    """load_vicuna(quantize=True) on both sides: quantize_host_llama's codes
    and scales equal JAX's exactly. They also equal the port's
    quantize_llama_params (the on-card quantizer of chip_smoke.py's phase
    9) on the same dense tree, while JAX's jitted quantize_nav_params
    differs from its own host quantizer by one grid step at a few edges
    (XLA multiplies by the scale's reciprocal)."""
    d = ckpt["st"]
    for dtype in (torch.float32, torch.bfloat16):
        _, tq = TCV.load_vicuna(d, 1024, dtype=dtype, quantize=True,
                                quant_bits=bits, device="cpu")
        _, jq = JCV.load_vicuna(str(d), 1024, dtype=_jdtype(dtype),
                                quantize=True, quant_bits=bits)
        _assert_same_tree(tq, jq, f"w{bits} {dtype}")
        assert TQ.weight_bits({"llm": tq}) == bits
        _, dense = TCV.load_vicuna(d, 1024, dtype=dtype, device="cpu")
        _assert_same_tree(TQ.quantize_llama_params(dense, bits), tq,
                          "host = quantize_llama_params")
    dense = JCV.load_vicuna_streaming(str(d), 1024, dtype=jnp.float32)[1]
    jit = flatten_tree(jax.tree.map(np.asarray, JQ._quantize_llama_impl(
        jax.tree.map(jnp.asarray, dense), bits)))
    host = flatten_tree(JCV.load_vicuna(str(d), 1024, dtype=jnp.float32,
                                        quantize=True, quant_bits=bits)[1])
    differs = [k for k in host if not np.array_equal(host[k], jit[k])]
    assert differs, "JAX's jit and host quantizers now agree: say so"


# ------------------------------------------------------- build_runner --- #
def _same_config(tc, jc):
    """NavModelConfig of the port == JAX's, field for field (dtypes by
    name; the port's q4_impl is its own)."""
    for f in dataclasses.fields(jc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(b):
            _same_config(a, b)
        elif f.name == "dtype":
            assert _dtype_name(torch.empty(0, dtype=a)) == \
                jnp.dtype(b).name, f.name
        else:
            assert a == b, (f.name, a, b)


def _args(cls, d, **kw):
    return cls(**{**dict(pretrained_model_name_or_path=str(d), seed=0,
                         image_feat_size=32, obj_feat_size=16), **kw})


@pytest.mark.parametrize("case", [
    dict(precision="bf16"), dict(precision="fp32"),
    dict(precision="fp32", enable_og=True, fuse_obj=True),
    dict(precision="fp32", fuse_obj=True),
    dict(precision="bf16", from_scratch=True),
    dict(precision="fp32", resume_from_checkpoint="ckpt/latest"),
    dict(precision="fp32", quantize_llm=True, quant_bits=4, mode="test",
         act_int8=True)])
def test_build_runner_matches_jax(ckpt, case):
    """The pretrained branch on both sides: the NavModelConfig field for
    field (the full panorama encoder, --fuse_obj taken as given, as JAX
    takes it, and act_int8), the tree's keys, shapes and dtypes, the LLM
    bit for bit where it is loaded, and the tokenizer's ids."""
    d = ckpt["st"]
    jr = JTL.build_runner(_args(JCFG.TrainArgs, d, **case), None)
    tr = TTL.build_runner(_args(TCFG.TrainArgs, d, device="cpu", **case),
                          None)
    _same_config(tr.cfg, jr.cfg)
    assert tr.cfg.pano.hidden_size == 1024 and tr.cfg.llm.num_layers == 3
    assert tr.cfg.pano.fuse_obj == case.get("fuse_obj", False)
    got = {n: p for n, p in tr.model.named_parameters()}
    want = flatten_tree(jax.tree.map(np.asarray, jr.params))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert tuple(got[n].shape) == w.shape and \
            _dtype_name(got[n]) == w.dtype.name, n
    if not (case.get("from_scratch") or case.get("resume_from_checkpoint")):
        _assert_same_tree({k[4:]: v for k, v in got.items()
                           if k.startswith("llm.")},
                          {k[4:]: v for k, v in want.items()
                           if k.startswith("llm.")}, "loaded LLM")
    for a in TOK_ATTRS:
        assert getattr(tr.tok, a) == getattr(jr.tok, a), a


def test_build_runner_keeps_its_refusals(ckpt):
    d = ckpt["st"]
    for kw, err, match in ((dict(quantize_llm=True), ValueError,
                            "eval-only"),
                           (dict(act_int8=True), ValueError, "act_int8")):
        with pytest.raises(err, match=match):
            TTL.build_runner(_args(TCFG.TrainArgs, d, device="cpu", **kw),
                             None)
    with pytest.raises(FileNotFoundError):
        TTL.build_runner(_args(TCFG.TrainArgs, d / "nothing", device="cpu"),
                         None)


# ---------------------------------------------------- whole-path runs --- #
RUN_CFG = """
Feature: {image_feat_size: 32, angle_feat_size: 4}
Dataset:
  R2R:
    DIR: "R2R"
    SPLIT: {"train": "annotations/R2R_train_enc.json",
            "val_unseen": "annotations/R2R_val_unseen_enc.json"}
Pretrain: {SOURCE: ['R2R'], Ratio: [1], LOSS_COEF: {}}
Multi: {SOURCE: ['R2R'], Ratio: [1], LOSS_COEF: {}}
Model: {num_pano_layers: 1, enc_full_graph: True, expert_policy: "spl"}
Optim:
  train_max_action_len: {"R2R": 4}
  val_max_action_len: {"R2R": 5}
"""
LR = 1e-3


def _run_args(cls, data_dir, out, d, **kw):
    return cls(**{**dict(data_dir=str(data_dir), output_dir=str(out),
                         pretrained_model_name_or_path=str(d),
                         precision="fp32", num_epochs=1,
                         num_steps_per_epoch=2, gradient_accumulation_step=2,
                         batch_size=2, val_batch_size=2, image_feat_size=32,
                         num_pano_layers=1, lr=LR, feat_dropout=0.0,
                         fused_rows_per_call=3, seed=0), **kw})


def _twin_runners(args_j, args_t):
    """Both build_runners from the checkpoint; then runners over the same
    weights without dropout: the port's LLM as it loaded it (held equal to
    JAX's), the rest converted from JAX's draw."""
    jr = JTL.build_runner(args_j, None)
    tr = TTL.build_runner(args_t, None)
    jcfg = dataclasses.replace(jr.cfg, pano=dataclasses.replace(
        jr.cfg.pano, hidden_dropout_prob=0.0))
    tcfg = dataclasses.replace(tr.cfg, pano=dataclasses.replace(
        tr.cfg.pano, hidden_dropout_prob=0.0))
    params = jax.tree.map(np.asarray, jr.params)
    _assert_same_tree(dict(tr.model.llm.named_parameters()), params["llm"],
                      "loaded LLM")
    tparams = params_from_jax({k: v for k, v in params.items()
                               if k != "llm"}, device="cpu")
    tparams["llm"] = tr.model.llm
    jrun = JRunner(jcfg, jax.tree.map(jnp.asarray, params), jr.tok,
                   dims=JDims.tiny(), feat_dropout=0.0)
    trun = NavModelRunner(tcfg, TNM.NavModel(tcfg, tparams), tr.tok,
                          dims=RolloutDims.tiny(), feat_dropout=0.0)
    return jrun, trun


def test_run_training_from_the_checkpoint_matches_jax(ckpt, data_dir,
                                                      tmp_path, monkeypatch):
    """pretrain.sh's shape on the tiny checkpoint: one epoch of 2 batches
    (one optimizer step), validation and the periodic checkpoint, on both
    sides; the same first losses (tests/test_torch_driver.py's tolerance)
    and scores."""
    d = ckpt["st"]
    common = dict(stage="pretrain", save_ckpt_per_epochs=1)
    losses = {}

    def recorder(module, key, pick):
        orig = module.train_one_epoch

        def wrapped(*a, **k):
            out = orig(*a, **k)
            losses[key] = pick(out)
            return out
        monkeypatch.setattr(module, "train_one_epoch", wrapped)
    recorder(JTL, "jax", lambda out: out[1])
    recorder(TTL, "port", lambda out: out[0])
    args_j = _run_args(JCFG.TrainArgs, data_dir, tmp_path / "jax", d,
                       **common)
    args_t = _run_args(TCFG.TrainArgs, data_dir, tmp_path / "port", d,
                       device="cpu", **common)
    jrun, trun = _twin_runners(args_j, args_t)
    jres = JTL.run_training(
        args_j, JCFG.ConfigDict(yaml.safe_load(RUN_CFG)),
        world=JWorld(str(data_dir / "connectivity")),
        feat_dbs={"mp3d": JFeatures(32)}, obj_feat_dbs={}, runner=jrun)
    res = TTL.run_training(
        args_t, TCFG.load_yaml_text(RUN_CFG),
        world=WorldModel(str(data_dir / "connectivity")),
        feat_dbs={"mp3d": SyntheticImageFeaturesDB(32)}, runner=trun)
    assert losses["port"] == pytest.approx(losses["jax"], rel=1e-4)
    assert losses["port"] > 0
    for k, v in jres["R2R"].items():
        assert res["R2R"][k] == pytest.approx(float(v), rel=1e-6,
                                              abs=1e-9), k
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_eval_logits_match_jax(ckpt, bits):
    """eval_r2r.sh with --quantize_llm [--quant_bits 4]: build_runner's
    int8/int4 tree on both sides, then one navigation step's logits on the
    same batch and weights (tests/test_torch_nav_model.py's tolerance)."""
    d = ckpt["st"]
    kw = dict(quantize_llm=True, quant_bits=bits, mode="test")
    jrun, trun = _twin_runners(
        _run_args(JCFG.TrainArgs, ".", ".", d, **kw),
        _run_args(TCFG.TrainArgs, ".", ".", d, device="cpu", **kw))
    assert TQ.weight_bits(trun.model) == bits
    batch = synthetic_nav_batch(jrun.cfg, b=3, g=12, v=8, c=8, hh=4,
                                tlen=48, seed=4)
    batch["attention_mask"][1, :6] = False          # left padding
    want = JNM.forward_navigation(jrun.params, jrun.cfg, batch)
    with torch.no_grad():
        got = trun.model({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["fuse_logits"].numpy(),
                               np.asarray(want["fuse_logits"]), **TOL)
    np.testing.assert_array_equal(got["fuse_logits"].argmax(-1).numpy(),
                                  np.asarray(want["fuse_logits"]).argmax(-1))


def test_from_scratch_train_then_resume_eval(ckpt, data_dir, tmp_path):
    """ablation/from_scratch.sh, then eval_r2r.sh: --from_scratch trains
    from config.json's architecture with 8-bit moments and saves; --mode
    test --resume_from_checkpoint from the same directory restores the
    trained weights bit for bit and validates."""
    d = ckpt["st"]
    cfg = TCFG.load_yaml_text(RUN_CFG)
    feats = {"mp3d": SyntheticImageFeaturesDB(32)}
    world = WorldModel(str(data_dir / "connectivity"))
    args = _run_args(TCFG.TrainArgs, data_dir, tmp_path, d, device="cpu",
                     stage="multi", from_scratch=True, adam_8bit=True,
                     max_saved_checkpoints=1, save_latest_states=True)
    runner = TTL.build_runner(args, cfg)
    loaded = TCV.load_vicuna(d, runner.tok.vocab_size, dtype=torch.float32,
                             device="cpu")[1]
    assert not torch.equal(runner.model.llm["layers"]["wq"],
                           loaded["layers"]["wq"])       # not loaded
    res = TTL.run_training(args, cfg, world=world, feat_dbs=feats,
                           runner=runner)
    assert "sr" in res["R2R"]
    saved = json.loads((tmp_path / "latest.json").read_text())
    assert saved == {"epoch": 0, "backend": "npz", "has_opt": True}
    keys = np.load(tmp_path / "latest.npz").files
    assert any(k.startswith("opt/1/0/.qm/llm/layers/") for k in keys)
    trained = {n: p.detach().clone()
               for n, p in runner.model.named_parameters()}

    eval_args = _run_args(TCFG.TrainArgs, data_dir, tmp_path / "eval", d,
                          device="cpu", mode="test",
                          resume_from_checkpoint=str(tmp_path / "epoch_0"))
    restored = {}
    orig = TTL.load_checkpoint

    def load(path, params, opt, logger):
        out = orig(path, params, opt, logger)
        restored.update({n: p.detach().clone()
                         for n, p in params.named_parameters()})
        assert opt is None
        return out
    TTL.load_checkpoint = load
    try:
        eres = TTL.run_training(eval_args, cfg, world=world, feat_dbs=feats)
    finally:
        TTL.load_checkpoint = orig
    assert "sr" in eres["R2R"]
    assert sorted(restored) == sorted(trained)
    for n, p in trained.items():
        assert torch.equal(restored[n], p), n
    assert TC.checkpoint_exists(tmp_path / "epoch_0")


# ------------------------------------------- a LLaMA-3-layout directory --- #
@pytest.fixture(scope="module")
def llama3_ckpt(tmp_path_factory):
    """A tiny LLaMA-3-layout GQA checkpoint: LlamaForCausalLM (3 layers,
    hidden 64, 4 heads over 2 KV heads, rope_theta 500000, rms_norm_eps
    1e-5, untied) over the llama3 fixture's vocabulary and its 256 special
    tokens, saved with the fixture's tokenizer files."""
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM
    spec = json.loads((LLAMA3_FIXTURE / "tokenizer.json").read_text())
    vocab = len(spec["model"]["vocab"]) + len(spec["added_tokens"])
    torch.manual_seed(3)
    hf = LlamaForCausalLM(HFConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0,
        bos_token_id=vocab - 256, eos_token_id=vocab - 255,
        tie_word_embeddings=False)).eval()
    d = tmp_path_factory.mktemp("llama3_tiny")
    hf.save_pretrained(d, safe_serialization=True)
    _llama3_layout(d)
    return d


STOP_BIAS = -1.5


def _stream(runner, root, prefix_cache, port: bool):
    """Greedy R2R streaming evaluation of root's val episodes in slots of
    2 through one package's runner: ({instr_id: trajectory}, every step's
    candidate logits as numpy, in order)."""
    logits = []
    for name in ("eval_step", "eval_step_cached"):
        orig = getattr(runner, name)

        def rec(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            logits.append(_np(out[-1]))
            return out
        setattr(runner, name, rec)
    feat = runner.cfg.pano.image_feat_size
    split = "annotations/val.json"
    if port:
        from navillm_tpu_torch.agents.mp3d_agent import EvalArgs, R2RAgent
        from navillm_tpu_torch.data.loaders import Dataloader
        from navillm_tpu_torch.data.r2r import R2RDataset
        from navillm_tpu_torch.testing import eval_config
        world = WorldModel(str(root / "connectivity"))
        ds = R2RDataset(root / "R2R" / split, world)
        ds.init_feat_db(SyntheticImageFeaturesDB(feat))
        args = EvalArgs(seed=0, val_batch_size=2, image_feat_size=feat,
                        prefix_cache=prefix_cache)
        preds = R2RAgent(args, world, runner).validate_streaming(
            "R2R", args, eval_config(5), Dataloader(ds, 2, False),
            dataset=ds)
    else:
        from navillm_tpu.agents import load_agent
        from navillm_tpu.data.datasets import load_dataset
        from navillm_tpu.data.loaders import Dataloader as JLoader
        from navillm_tpu.utils.config import ConfigDict
        cfg = ConfigDict({
            "Feature": {"image_feat_size": feat, "angle_feat_size": 4},
            "R2R": {"DIR": "R2R", "SPLIT": {"val_unseen": split}}})
        args = JCFG.TrainArgs(data_dir=str(root), val_batch_size=2, seed=0)
        args.image_feat_size = feat
        args.prefix_cache = prefix_cache
        world = JWorld(str(root / "connectivity"))
        ds = load_dataset("r2r", args, cfg, training=False, source="R2R",
                          world=world)
        ds.init_feat_db(JFeatures(feat))
        preds = load_agent("r2r", args, world, runner).validate_streaming(
            "R2R", args, ConfigDict({"Optim": {
                "val_max_action_len": {"R2R": 5}}}),
            JLoader(ds, 2, False), dataset=ds)
    for name in ("eval_step", "eval_step_cached"):
        delattr(runner, name)
    return {p["instr_id"]: p["trajectory"] for p in preds}, logits


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["uncached", "cached"])
def test_llama3_layout_slice_matches_jax(llama3_ckpt, tmp_path,
                                         prefix_cache):
    """The slice on a LLaMA-3-layout directory: both build_runners read its
    config.json (GQA 4/2, rope_theta 500000) and its tokenizer (the Split
    regex and ByteLevel, 256 special tokens, <PAD> added), the LLM loaded
    equal bit for bit and the rest carried by params_from_jax (the stop
    logit's bias set to -1.5, so that episodes stop at mixed steps, 1 to 5);
    then greedy R2R streaming
    evaluation, uncached or prefix-cached, on both: the same trajectories,
    and every step's candidate logits within TOL (f32, this file's bound
    for one navigation step's logits)."""
    T.make_r2r_world(tmp_path, n_episodes=6, rows=4, cols=4, seed=3)
    jrun, trun = _twin_runners(
        _run_args(JCFG.TrainArgs, ".", ".", llama3_ckpt, mode="test"),
        _run_args(TCFG.TrainArgs, ".", ".", llama3_ckpt, device="cpu",
                  mode="test"))
    llm = trun.cfg.llm
    assert (llm.num_heads, llm.num_kv_heads, llm.rope_theta,
            llm.rms_norm_eps) == (4, 2, 500000.0, 1e-5)
    assert trun.tok.bos_token == T.LLAMA3_BOS and \
        trun.tok.pad_id == trun.tok.unk_id == trun.tok.true_vocab_size - 1
    jrun.params["out_head"]["b"] = jrun.params["out_head"]["b"].at[0].set(
        STOP_BIAS)
    with torch.no_grad():
        trun.model.out_head.b[0] = STOP_BIAS
    want, want_logits = _stream(jrun, tmp_path, prefix_cache, port=False)
    got, got_logits = _stream(trun, tmp_path, prefix_cache, port=True)
    if prefix_cache:
        assert trun.cached_steps > 0 and trun.prefill_calls > 0 and \
            trun.eval_steps == 0
    assert len(got) == 6 and got == want
    assert len({len(t) for t in got.values()}) > 1        # mixed lengths
    assert len(got_logits) == len(want_logits) > 0
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, **TOL)
