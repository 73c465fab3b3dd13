"""Write the LLaMA-3-layout tokenizer fixture.

The fixture (``tests/fixtures/llama3_bpe/``) is a byte-level BPE in the
layout of Meta-Llama-3-8B's ``tokenizer.json``, trained here on the
synthetic prompt corpus of ``scripts/data_tools/train_bpe.py`` (no
download):
  - pre-tokenizer ``Sequence[Split(Regex(LLAMA3_PATTERN), Isolated),
    ByteLevel(use_regex=False)]``, a ``BPE`` model with ``ignore_merges``,
    the ``ByteLevel`` decoder and LLaMA-3's post-processor (a
    ``<|begin_of_text|>`` before the text);
  - the 256 byte characters and the merges training finds (it stops at
    757 of the ``N_MERGES`` asked for: every word of the corpus is then
    one token), then LLaMA-3's 256
    special tokens (``<|begin_of_text|>``, ``<|end_of_text|>``, the
    reserved ones, ``<|eot_id|>``), in LLaMA-3's order, right after the
    vocabulary;
  - ``tokenizer_config.json``: LLaMA-3's
    (``testing.llama3_tokenizer_config``: a ``PreTrainedTokenizerFast``
    with ``<|begin_of_text|>`` / ``<|end_of_text|>``, no unk or pad token,
    the special tokens in ``added_tokens_decoder``).

``navillm_tpu_torch.testing.llama3_tokenizer_spec`` extends it to
LLaMA-3's 128000 entries and moves the special tokens to 128000-128255;
chip_smoke.py's phase 49 runs that file on the card.
``tests/test_torch_tokenizer_json.py`` rewrites the fixture in a temporary
directory and asserts it is byte for byte the committed one.

Needs ``tokenizers`` (and the JAX package's prompts, which the corpus
reads).

Usage: python scripts/data_tools/make_llama3_fixture.py [--out DIR]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "llama3_bpe"
# Meta-Llama-3-8B's tokenizer.json pre-tokenizer pattern
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                  r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                  r"\s+(?!\S)|\s+")
# the merges asked for; the corpus's words are all single tokens after 757
N_MERGES = 4000


def corpus() -> list:
    spec = importlib.util.spec_from_file_location(
        "train_bpe", ROOT / "scripts" / "data_tools" / "train_bpe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_corpus()


def build():
    """The fixture's ``tokenizers.Tokenizer``."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            pre_tokenizers, processors, trainers)

    from navillm_tpu_torch.testing import LLAMA3_BOS as BOS
    from navillm_tpu_torch.testing import llama3_specials
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True,
                                 use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=len(alphabet) + N_MERGES, show_progress=False,
        initial_alphabet=alphabet))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in llama3_specials()])
    bos = tok.token_to_id(BOS)
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single=f"{BOS} $A", pair=f"{BOS} $A {BOS}:1 $B:1",
            special_tokens=[(BOS, bos)])])
    return tok


def write_fixture(out: Path = FIXTURE) -> Path:
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    from navillm_tpu_torch.testing import llama3_tokenizer_config
    tok = build()
    tok.save(str(out / "tokenizer.json"))
    first = tok.get_vocab_size(with_added_tokens=False)
    (out / "tokenizer_config.json").write_text(
        json.dumps(llama3_tokenizer_config(first), indent=2) + "\n")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    print(write_fixture(ap.parse_args().out))


if __name__ == "__main__":
    main()
