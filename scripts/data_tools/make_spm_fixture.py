"""Write the sentencepiece fixtures: a LLaMA-layout ``tokenizer.model`` and
the ``tokenizer.json`` transformers converts from it, for a BPE model and
for a Unigram one.

The BPE fixture (``tests/fixtures/spm_llama/``) holds:
  - ``tokenizer.model``: ``navillm_tpu_torch.testing.spm_pieces(1016)``
    (the seeded BPE pieces, as many as the BPE vocabulary chip_smoke.py's
    7B-width checkpoint has) written by
    ``testing.write_sentencepiece_model``;
  - ``tokenizer.json``: transformers' ``LlamaConverter`` run on that model
    for a ``LlamaTokenizer`` with its defaults (``legacy`` and
    ``add_prefix_space`` True), saved by ``tokenizers``;
  - ``tokenizer_config.json``: a slow ``LlamaTokenizer``'s, as a Vicuna
    directory has it.

The Unigram fixture (``tests/fixtures/spm_unigram/``) holds the same
pieces in a Unigram model (trainer ``model_type`` 1), the ``tokenizer.json``
``LlamaConverter`` makes of it (a ``Unigram`` model, through
``SpmConverter.tokenizer``) and the same config.

``navillm_tpu_torch.models.sentencepiece`` reads ``tokenizer.model`` by
hand, and chip_smoke.py holds the ids it gives against the
``tokenizer.json`` twin on a machine that has neither ``transformers`` nor
``tokenizers``. ``tests/test_torch_sentencepiece.py`` rewrites both
fixtures in a temporary directory and asserts they are byte for byte the
committed ones.

``convert`` needs ``transformers`` and ``protobuf`` (not ``sentencepiece``:
see ``ProtoExtractor``).

Usage: python scripts/data_tools/make_spm_fixture.py [--out DIR]
           [--unigram-out DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "spm_llama"
UNIGRAM_FIXTURE = ROOT / "tests" / "fixtures" / "spm_unigram"
N_PIECES = 1016
TOKENIZER_CONFIG = {
    "add_bos_token": True, "add_eos_token": False,
    "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
    "pad_token": None, "clean_up_tokenization_spaces": False,
    "model_max_length": 2048, "padding_side": "right",
    "sp_model_kwargs": {}, "tokenizer_class": "LlamaTokenizer"}


class ProtoExtractor:
    """``SentencePieceExtractor`` with protobuf in place of sentencepiece.

    transformers' extractor loads the model with sentencepiece only to read
    ``{sp.id_to_piece(i): i}``; ``id_to_piece(i)`` is the ``ModelProto``'s
    ``pieces[i].piece``, which this reads with protobuf. Nothing else of
    the conversion changes: the merges come from transformers' own
    ``generate_merges``."""

    def __init__(self, model: str):
        from transformers.convert_slow_tokenizer import import_protobuf
        self.proto = import_protobuf().ModelProto()
        self.proto.ParseFromString(Path(model).read_bytes())

    def extract(self, vocab_scores=None):
        from transformers.convert_slow_tokenizer import generate_merges
        vocab = {p.piece: i for i, p in enumerate(self.proto.pieces)}
        return vocab, generate_merges(vocab, vocab_scores)


class SlowLlamaStub:
    """What ``LlamaConverter`` reads of a slow ``LlamaTokenizer``: its file,
    ``legacy`` and ``add_prefix_space`` (the slow class's defaults, True
    and True), and ``convert_ids_to_tokens`` (sentencepiece's
    ``id_to_piece``, the proto's piece strings)."""

    def __init__(self, vocab_file, legacy=True, add_prefix_space=True):
        self.vocab_file = str(vocab_file)
        self.legacy = legacy
        self.add_prefix_space = add_prefix_space
        self._pieces = ProtoExtractor(vocab_file).proto.pieces

    def convert_ids_to_tokens(self, i):
        return self._pieces[i].piece


def convert(model_path, legacy=True, add_prefix_space=True):
    """transformers' ``LlamaConverter(...).converted()`` of the model at
    ``model_path``: a ``tokenizers.Tokenizer``."""
    import warnings
    from transformers.convert_slow_tokenizer import LlamaConverter

    class Converter(LlamaConverter):
        SpmExtractor = ProtoExtractor

    with warnings.catch_warnings():
        # SpmConverter warns about byte fallback, which LlamaConverter runs
        warnings.simplefilter("ignore")
        return Converter(SlowLlamaStub(model_path, legacy,
                                       add_prefix_space)).converted()


def write_fixture(out: Path = FIXTURE, model_type: int = 2) -> Path:
    """The fixture of a BPE (``model_type`` 2) or Unigram (1) model."""
    from navillm_tpu_torch import testing as T
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    T.write_sentencepiece_model(out / "tokenizer.model",
                                T.spm_pieces(N_PIECES), model_type)
    convert(out / "tokenizer.model").save(str(out / "tokenizer.json"))
    (out / "tokenizer_config.json").write_text(
        json.dumps(TOKENIZER_CONFIG, indent=2) + "\n")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    ap.add_argument("--unigram-out", type=Path, default=UNIGRAM_FIXTURE)
    args = ap.parse_args()
    print(write_fixture(args.out))
    print(write_fixture(args.unigram_out, model_type=1))


if __name__ == "__main__":
    main()
