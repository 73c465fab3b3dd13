"""A sentencepiece ``tokenizer.model`` read by hand, and the fast-tokenizer
spec that transformers' ``LlamaConverter`` makes from it.

A Vicuna or LLaMA directory saved by a slow ``LlamaTokenizer`` holds a
sentencepiece model (a serialized ``ModelProto``) and often no
``tokenizer.json``. transformers turns such a model into a fast tokenizer
with ``LlamaConverter`` (transformers 4.57, ``convert_slow_tokenizer.py``):
it parses the proto with ``protobuf``, reads each piece's string through
``sentencepiece`` (``SentencePieceExtractor``: ``{id_to_piece(i): i}``,
which is the proto's ``pieces[i].piece``), derives the BPE merges from the
pieces' scores (``generate_merges``; a Unigram model keeps its scored
pieces as a ``Unigram`` model) and assembles the normalizer,
pre-tokenizer and decoder from the tokenizer's ``legacy`` and
``add_prefix_space``. The card's machine has neither ``protobuf``,
``sentencepiece``, ``transformers`` nor ``tokenizers``, so this module
reads the protobuf wire format itself and writes the same spec as a dict,
which ``tokenization.TokenizerFile`` runs.
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple, Union

# SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# (name, kind, default) of the scalar fields read, by field number; the
# others are skipped by wire type
_TRAINER_FIELDS = {
    3: ("model_type", "enum", UNIGRAM),
    4: ("vocab_size", "int", 8000),
    35: ("byte_fallback", "bool", False),
    40: ("unk_id", "int", 0),
    41: ("bos_id", "int", 1),
    42: ("eos_id", "int", 2),
    43: ("pad_id", "int", -1),
    45: ("unk_piece", "str", "<unk>"),
    46: ("bos_piece", "str", "<s>"),
    47: ("eos_piece", "str", "</s>"),
    48: ("pad_piece", "str", "<pad>"),
}
_NORMALIZER_FIELDS = {
    1: ("name", "str", ""),
    2: ("precompiled_charsmap", "bytes", b""),
    3: ("add_dummy_prefix", "bool", True),
    4: ("remove_extra_whitespaces", "bool", True),
    5: ("escape_whitespaces", "bool", True),
    6: ("normalization_rule_tsv", "str", ""),
}


@dataclasses.dataclass(frozen=True)
class Piece:
    piece: str
    score: float = 0.0
    type: int = NORMAL


@dataclasses.dataclass
class SentencePieceModel:
    pieces: List[Piece]
    trainer_spec: Dict[str, object]
    normalizer_spec: Dict[str, object]
    where: str = "<bytes>"


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """(field number, wire type, value) of one message: an int for a
    varint, the raw bytes of a fixed32/fixed64 or length-delimited field."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, pos = _varint(buf, pos)
        elif wire == _I64:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == _I32:
            val, pos = buf[pos:pos + 4], pos + 4
        elif wire == _LEN:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"field {num}: wire type {wire} (groups) is not "
                             f"read")
        if pos > len(buf):
            raise ValueError(f"field {num} runs past the end of its message")
        yield num, wire, val


def _scalar(kind: str, wire: int, val):
    if kind in ("int", "enum"):
        if wire != _VARINT:
            raise ValueError(f"an integer field with wire type {wire}")
        # int32 values are sign-extended to 64 bits on the wire
        return val - (1 << 64) if val >> 63 else val
    if kind == "bool":
        return bool(val)
    if kind == "str":
        return val.decode("utf-8")
    if kind == "bytes":
        return bytes(val)
    raise AssertionError(kind)


def _spec(buf: bytes, table, out: Dict[str, object]) -> Dict[str, object]:
    """Merge one sub-message into ``out`` (a later value of a field wins, as
    protobuf merges a repeated sub-message)."""
    for num, wire, val in _fields(buf):
        if num in table:
            name, kind, _ = table[num]
            out[name] = _scalar(kind, wire, val)
    return out


def _piece(buf: bytes) -> Piece:
    piece, score, kind = "", 0.0, NORMAL
    for num, wire, val in _fields(buf):
        if num == 1 and wire == _LEN:
            piece = val.decode("utf-8")
        elif num == 2 and wire == _I32:
            score = struct.unpack("<f", val)[0]
        elif num == 3 and wire == _VARINT:
            kind = val
    return Piece(piece, score, kind)


def parse_model(data: bytes, where: str = "<bytes>") -> SentencePieceModel:
    """A serialized ``ModelProto``: its pieces (``piece``, ``score``,
    ``type``), the trainer spec's model type, special ids and pieces and
    ``byte_fallback``, and the normalizer spec, each field at its proto
    default when absent."""
    trainer = {name: d for name, _, d in _TRAINER_FIELDS.values()}
    normalizer = {name: d for name, _, d in _NORMALIZER_FIELDS.values()}
    pieces: List[Piece] = []
    try:
        for num, wire, val in _fields(data):
            if wire != _LEN:
                continue
            if num == 1:
                pieces.append(_piece(val))
            elif num == 2:
                _spec(val, _TRAINER_FIELDS, trainer)
            elif num == 3:
                _spec(val, _NORMALIZER_FIELDS, normalizer)
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"{where}: not a sentencepiece model ({e})") from e
    return SentencePieceModel(pieces, trainer, normalizer, where)


def load_model(path) -> SentencePieceModel:
    return parse_model(Path(path).read_bytes(), where=str(path))


def generate_merges(vocab: Dict[str, int],
                    vocab_scores: List[Tuple[str, float]]
                    ) -> List[Tuple[str, str]]:
    """transformers' ``generate_merges`` over scored pieces: every split of
    a piece into two pieces of the vocabulary, within a piece by the
    halves' ids, then a stable sort on (score, len(left), len(right)),
    highest first."""
    merges = []
    for merge, piece_score in dict(vocab_scores).items():
        local = []
        for index in range(1, len(merge)):
            left, right = merge[:index], merge[index:]
            if left in vocab and right in vocab:
                local.append((left, right, piece_score))
        local.sort(key=lambda x: (vocab[x[0]], vocab[x[1]]))
        merges.extend(local)
    merges.sort(key=lambda v: (v[2], len(v[0]), len(v[1])), reverse=True)
    return [(v[0], v[1]) for v in merges]


def _replace(old: str, new: str) -> dict:
    return {"type": "Replace", "pattern": {"String": old}, "content": new}


def llama_tokenizer_spec(model: SentencePieceModel, legacy=True,
                         add_prefix_space=True) -> dict:
    """The ``tokenizer.json`` that ``LlamaConverter(tok).converted()``
    writes for a ``LlamaTokenizer`` over ``model`` with these ``legacy`` and
    ``add_prefix_space`` (read for their truth, as the converter does).

    For a BPE model (LLaMA's and Vicuna's) the vocabulary is the pieces by
    id (ids 0-2 scored 0.0), the merges
    come from ``generate_merges`` over the scores, with ``byte_fallback``,
    ``fuse_unk`` and the trainer's ``unk_piece``; CONTROL pieces are added
    as special tokens and USER_DEFINED ones as plain added tokens. Legacy:
    the normalizer prepends "▁" (when ``add_prefix_space``) and replaces
    spaces by it, and there is no pre-tokenizer; otherwise no normalizer and
    a ``Metaspace`` pre-tokenizer that prepends only at the text's start
    (``first``, or ``never`` without ``add_prefix_space``). The decoder
    undoes "▁", the byte pieces and, with ``add_prefix_space``, one leading
    space. A Unigram model (``model_type`` 1) converts as
    ``SpmConverter.tokenizer`` does it: a ``Unigram`` model over the same
    scored pieces with ``unk_id`` 0 and byte fallback, and the same
    normalizer, pre-tokenizer, decoder and added tokens. A word or char
    model raises ValueError."""
    kind = model.trainer_spec["model_type"]
    pieces = model.pieces
    scored = [(p.piece, 0.0 if i < 3 else p.score)
              for i, p in enumerate(pieces)]
    if kind == BPE:
        sp_vocab = {p.piece: i for i, p in enumerate(pieces)}
        merges = generate_merges(sp_vocab, scored)
        spec = {"type": "BPE", "dropout": None,
                "unk_token": model.trainer_spec["unk_piece"],
                "continuing_subword_prefix": None,
                "end_of_word_suffix": None, "fuse_unk": True,
                "byte_fallback": True, "ignore_merges": False,
                "vocab": {piece: i for i, (piece, _) in enumerate(scored)},
                "merges": [list(m) for m in merges]}
    elif kind == UNIGRAM:
        spec = {"type": "Unigram", "unk_id": 0,
                "vocab": [list(v) for v in scored], "byte_fallback": True}
    else:
        name = {WORD: "word", CHAR: "char"}.get(kind, str(kind))
        raise ValueError(f"{model.where}: a {name} sentencepiece model; only "
                         f"BPE and Unigram models are read")
    vocab = {piece: i for i, (piece, _) in enumerate(scored)}
    added = [{"id": vocab[p.piece], "content": p.piece, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": p.type == CONTROL}
             for p in pieces if p.type in (CONTROL, USER_DEFINED)]
    if legacy:
        steps = ([{"type": "Prepend", "prepend": "▁"}]
                 if add_prefix_space else [])
        normalizer = {"type": "Sequence",
                      "normalizers": steps + [_replace(" ", "▁")]}
        pre_tokenizer = None
    else:
        normalizer = None
        pre_tokenizer = {"type": "Metaspace", "replacement": "▁",
                         "prepend_scheme": ("first" if add_prefix_space
                                            else "never"),
                         "split": False}
    decoders = [_replace("▁", " "), {"type": "ByteFallback"},
                {"type": "Fuse"}]
    if add_prefix_space:
        decoders.append({"type": "Strip", "content": " ", "start": 1,
                         "stop": 0})
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": normalizer,
        "pre_tokenizer": pre_tokenizer, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": decoders},
        "model": spec,
    }
