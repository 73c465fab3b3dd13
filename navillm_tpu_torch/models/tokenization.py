"""Tokenizer adapter: the hermetic byte tokenizer, the vendored BPE and HF
fast-tokenizer directories.

The port's copy of ``TokenBatch``, ``ByteTokenizer``, ``BPETokenizer``,
``HFTokenizer`` and ``NavTokenizer`` from navillm_tpu/models/tokenization.py,
with the same names, ids and masks. It keeps the reference's tokenizer
contract (models/modified_lm.py:56-87):
  - special tokens `<cand> <hist> <obj> <cls_1> <cls_2>` (+ `<PAD>`),
  - left padding and left truncation at max_length=1024,
  - pair encoding [prompt, answer] with token_type_ids 0/1 used for
    label masking (nav_model.py:305-316).
Batches pad to a bucketed static length (a multiple of
``pad_to_multiple``), and the embedding table is sized up to a multiple
of 128 (ids >= the true vocab are masked in the logits).

``TokenizerFile`` reads a fast-tokenizer ``tokenizer.json`` and runs it in
plain Python, without the ``tokenizers`` or ``transformers`` packages (the
card's machine has neither): the byte-level layout of ``bpe_nav.json``
(``BPETokenizer``, the GPT-2 split written out over ``str``), the Llama
layouts (byte-fallback BPE under the legacy ``Prepend``/``Replace``
normalizer or the ``Metaspace`` pre-tokenizer), the LLaMA-3 one (a regex
``Split``, then ``ByteLevel`` without one) and the others its docstring
lists, with BPE or Unigram models (``models/pretokenize.py``,
``models/unigram.py``).
``NavTokenizer.from_pretrained`` reads such a directory through
``HFTokenizer``, and a directory with a sentencepiece ``tokenizer.model``
and no ``tokenizer.json`` as transformers converts it for a
``LlamaTokenizer`` (``models/sentencepiece.py`` reads the model and writes
the spec ``TokenizerFile`` runs). ``WordPieceDecoder`` decodes
bert-base-uncased ids from the local Hugging Face cache, as the augmented
datasets' ``.jsonl`` annotations need.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import pretokenize as PT
from .pretokenize import bytes_to_unicode, gpt2_split  # noqa: F401
from .unigram import UnigramModel

SPECIAL_TOKENS = ["<cand>", "<hist>", "<obj>", "<cls_1>", "<cls_2>"]


@dataclasses.dataclass
class TokenBatch:
    input_ids: np.ndarray       # [B, L] int32, left-padded
    attention_mask: np.ndarray  # [B, L] bool
    token_type_ids: np.ndarray  # [B, L] int32 (1 on answer tokens)

    @property
    def shape(self):
        return self.input_ids.shape


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ByteTokenizer:
    """Deterministic byte-level tokenizer for hermetic tests.

    Layout: 0=<unk> 1=<s> 2=</s> 3..258=bytes 259..263=schema specials
    264=<PAD>. Parses special-token strings (and </s>) inside text.
    """

    def __init__(self):
        self.unk_id, self.bos_id, self.eos_id = 0, 1, 2
        self._byte0 = 3
        self._special = {}
        nxt = self._byte0 + 256
        for tok in SPECIAL_TOKENS:
            self._special[tok] = nxt
            nxt += 1
        self.pad_id = nxt
        self._special["<PAD>"] = self.pad_id
        self._special["</s>"] = self.eos_id
        self._special["<s>"] = self.bos_id
        self.true_vocab_size = nxt + 1
        self.bos_token, self.eos_token, self.pad_token = "<s>", "</s>", "<PAD>"
        self._id_to_special = {v: k for k, v in self._special.items()}
        self._marker_re = None

    def encode(self, text: str) -> List[int]:
        """Regex-split on special-token markers, then map each byte segment
        in bulk with numpy."""
        if self._marker_re is None:
            markers = sorted(self._special, key=len, reverse=True)
            self._marker_re = re.compile(
                "(" + "|".join(re.escape(m) for m in markers) + ")")
        ids: List[int] = []
        for part in self._marker_re.split(text):
            if not part:
                continue
            sp = self._special.get(part)
            if sp is not None:
                ids.append(sp)
            else:
                ids.extend((np.frombuffer(part.encode("utf-8"),
                                          dtype=np.uint8)
                            .astype(np.int64) + self._byte0).tolist())
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens=True) -> str:
        out = bytearray()
        for t in ids:
            t = int(t)
            if self._byte0 <= t < self._byte0 + 256:
                out.append(t - self._byte0)
            elif not skip_special_tokens and t in self._id_to_special:
                out.extend(self._id_to_special[t].encode())
        return out.decode("utf-8", errors="replace")

    def special_token_id(self, tok: str) -> int:
        return self._special[tok]


class BPEModel:
    """The ``BPE`` model of a ``tokenizer.json`` without dropout or subword
    affixes: ``byte_fallback`` (``<0x00>``..``<0xFF>`` vocabulary entries),
    ``fuse_unk``, ``unk_token`` and ``ignore_merges``. ``tokenize(word)``
    merges the word's symbols by rank, lowest first and leftmost on a tie,
    as the library's priority queue does."""

    def __init__(self, model: dict, where: str):
        if model.get("dropout") or model.get("continuing_subword_prefix") \
                or model.get("end_of_word_suffix"):
            raise ValueError(f"{where}: not a BPE model this reader runs "
                             f"(no dropout, no subword affixes)")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks = {}
        for r, m in enumerate(model["merges"]):
            pair = tuple(m.split(" ", 1) if isinstance(m, str) else m)
            self.ranks[pair] = (r, pair[0] + pair[1])
        self.unk_token = model.get("unk_token")
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.fuse_unk = bool(model.get("fuse_unk"))
        self.ignore_merges = bool(model.get("ignore_merges"))

    def _symbols(self, word: str) -> List[str]:
        """The word's characters as vocabulary entries: a missing one is
        its UTF-8 bytes' ``<0xNN>`` entries (byte_fallback) or the unk
        token (consecutive ones fused under fuse_unk)."""
        out: List[str] = []
        unk = None          # a pending run of unknown characters
        for c in word:
            if c in self.vocab:
                if unk is not None:
                    out.append(self.unk_token)
                    unk = None
                out.append(c)
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(t in self.vocab for t in codes):
                    out.extend(codes)
                    continue
            if self.unk_token is None:
                raise ValueError(f"{c!r} is not in the vocabulary and the "
                                 f"model has no unk token")
            if unk is not None and not self.fuse_unk:
                out.append(self.unk_token)
            unk = True
        if unk is not None:
            out.append(self.unk_token)
        return out

    def tokenize(self, word: str) -> Tuple[int, ...]:
        """Ids of one pre-token: its symbols merged by rank (lowest first,
        leftmost on a tie, as a priority queue of (rank, position))."""
        if not word:
            return ()
        if self.ignore_merges and word in self.vocab:
            return (self.vocab[word],)
        sym = self._symbols(word)
        n = len(sym)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        ranks = self.ranks
        heap = []
        for i in range(n - 1):
            m = ranks.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            m = ranks.get((sym[i], sym[j]))
            if m is None or m[1] != new:
                continue                       # a stale entry
            sym[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = ranks.get((sym[prv[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = ranks.get((new, sym[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        vocab = self.vocab
        return tuple(vocab[s] for s, a in zip(sym, alive) if a)


DECODERS = ("ByteLevel", "Replace", "ByteFallback", "Fuse", "Strip",
            "Metaspace", "Sequence")


class TokenizerFile:
    """A fast-tokenizer file (``tokenizer.json``), read and run in plain
    Python, as the ``tokenizers`` package runs it.

    The parts it reads (anything else raises ValueError naming the part and
    the file):
      - normalizer: none, ``NFC`` / ``NFD`` / ``NFKC`` / ``NFKD``,
        ``Lowercase``, ``Strip``, ``StripAccents``, ``Prepend``,
        ``Replace`` (a string or an Oniguruma regex pattern), or a
        ``Sequence`` of them;
      - pre-tokenizer: none, ``ByteLevel`` (``add_prefix_space``,
        ``use_regex``: the GPT-2 split, or bytes mapped without a split),
        ``Split`` (a string or regex pattern, every behavior, ``invert``),
        ``Whitespace``, ``WhitespaceSplit``, ``Metaspace``
        (``prepend_scheme`` always / first / never, ``split``), ``Digits``,
        ``Punctuation``, or a ``Sequence`` of them (the LLaMA-3 layout:
        ``Split`` by its regex, then ``ByteLevel`` without one);
      - model: ``BPE`` (``BPEModel``) or ``Unigram``
        (``unigram.UnigramModel``);
      - decoder: none (tokens joined by a space), ``ByteLevel``,
        ``Replace`` (a string or regex pattern), ``ByteFallback``,
        ``Fuse``, ``Strip``, ``Metaspace``, or a ``Sequence`` of them.
    Regex patterns go through ``pretokenize.onig_to_re``.

    Encoding: the added tokens that are not normalized are split out of the
    raw text first (leftmost-longest); each other segment is normalized,
    split on the normalized added tokens (found in their normalized form),
    pre-tokenized and every piece run through the model (its ids cached per
    piece). Decoding drops the added
    tokens flagged special when asked, then runs the decoder.
    """

    def __init__(self, source: Union[str, os.PathLike, dict],
                 where: Optional[str] = None):
        """``source``: a ``tokenizer.json`` path, or its content as a dict
        (``where`` then names it in errors)."""
        if isinstance(source, dict):
            spec, where = source, where or "<tokenizer spec>"
        else:
            with open(source, encoding="utf-8") as f:
                spec = json.load(f)
            where = str(source)
        model = spec["model"]
        kind = model.get("type", "BPE")
        if kind == "BPE":
            self.model = BPEModel(model, where)
        elif kind == "Unigram":
            self.model = UnigramModel(model, where)
        else:
            raise ValueError(f"{where}: model {kind} is not read (BPE, "
                             f"Unigram)")
        self.vocab = self.model.vocab
        self._normalize = PT.normalizer(spec.get("normalizer"), where)
        self._offsets = PT.reads_offsets(spec.get("pre_tokenizer"))
        self._pre = PT.pre_tokenizer(spec.get("pre_tokenizer"), where)
        self._decoders = self._decoder(spec.get("decoder"), where)
        # added tokens: content -> (id, special, normalized)
        self.added: Dict[str, Tuple[int, bool, bool]] = {}
        for t in spec.get("added_tokens", []):
            if t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
                raise ValueError(f"{where}: added token {t['content']!r} "
                                 f"strips or matches single words, which "
                                 f"this reader does not do")
            self.added[t["content"]] = (t["id"], bool(t.get("special")),
                                        bool(t.get("normalized")))
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._piece_ids = functools.lru_cache(maxsize=65536)(
            self.model.tokenize)
        self._refresh()

    # ------------------------------------------------------------ parts
    def _decoder(self, spec, where):
        """The decoder as a chain of steps over the token strings."""
        if spec is None:
            return None
        parts = spec["decoders"] if spec["type"] == "Sequence" else [spec]
        steps = []
        for p in parts:
            kind = p["type"]
            if kind == "ByteLevel":
                steps.append(self._byte_level_decode)
            elif kind == "Replace":
                rep = PT.replacer(PT.pattern_regex(p, where), p["content"])
                steps.append(lambda toks, rep=rep: [rep(t) for t in toks])
            elif kind == "ByteFallback":
                steps.append(_byte_fallback_decode)
            elif kind == "Fuse":
                steps.append(lambda toks: ["".join(toks)])
            elif kind == "Strip":
                steps.append(lambda toks, c=p["content"], a=p["start"],
                             b=p["stop"]: [_strip(t, c, a, b) for t in toks])
            elif kind == "Metaspace":
                steps.append(PT.metaspace_decode(
                    p.get("replacement", "▁"), p.get("prepend_scheme") or (
                        "always" if p.get("add_prefix_space", True)
                        else "never")))
            else:
                raise ValueError(f"{where}: decoder {kind} is not read "
                                 f"({', '.join(DECODERS)})")
        return steps

    # --------------------------------------------------------- vocabulary
    def _refresh(self):
        self._id_to_token = dict(self.model.id_to_token)
        self._id_to_token.update({i: t for t, (i, _, _) in
                                  self.added.items()})
        self._special_ids = {i for i, s, _ in self.added.values() if s}

        # the normalized added tokens are found in the normalized text in
        # their normalized form, as the library's trie holds them
        self._norm_ids = {}
        for t, (i, _, n) in self.added.items():
            if n:
                form = t if self._normalize is None else \
                    self._normalize(t, 0, None)[0]
                if form:
                    self._norm_ids[form] = i

        def matcher(toks):
            toks = sorted(toks, key=len, reverse=True)
            return re.compile("|".join(map(re.escape, toks))) if toks \
                else None
        self._raw_re = matcher(t for t, (_, _, n) in self.added.items()
                               if not n)
        self._norm_re = matcher(self._norm_ids)

    def __len__(self) -> int:
        return len(set(self.vocab) | set(self.added))

    def token_to_id(self, tok: str) -> Optional[int]:
        if tok in self.added:
            return self.added[tok][0]
        return self.vocab.get(tok)

    def add_special_tokens(self, tokens: Sequence[str]):
        """Add ``tokens`` as special added tokens (never normalized or split),
        as the library does: a token already known keeps its id, a new one
        takes the next, which is the model's vocabulary size unless an added
        id already reaches past it."""
        for tok in tokens:
            tid = self.token_to_id(tok)
            if tid is None:
                n = len(self.vocab)
                top = max((i for i, _, _ in self.added.values()), default=None)
                tid = n if top is None or (n and top < n) else top + 1
            self.added[tok] = (tid, True, False)
        self._refresh()

    # ------------------------------------------------------------- encode
    def _encode_segment(self, text: str, shift: int, out: List[int]):
        """A segment between raw added tokens, ``shift`` its offset in the
        text: normalized (with each character's original offset when the
        pre-tokenizer reads them), split on the normalized added tokens,
        each part pre-tokenized on its own (its offset: its first
        character's) and run through the model."""
        orig = list(range(shift, shift + len(text))) if self._offsets \
            else None
        if self._normalize is not None:
            text, orig = self._normalize(text, shift, orig)
        for a, b, added in self._spans(self._norm_re, text):
            if added:
                out.append(self._norm_ids[text[a:b]])
                continue
            piece = (text[a:b], 0, None) if orig is None else \
                (text[a:b], orig[a], orig[a:b])
            for p in self._pre([piece]):
                out.extend(self._piece_ids(p[0]))

    @staticmethod
    def _spans(pattern, text: str):
        """(start, end, is an added token) over ``text``, split on the
        added tokens ``pattern`` matches (longest first at each
        position)."""
        pos = 0
        if pattern is not None:
            for m in pattern.finditer(text):
                if m.start() > pos:
                    yield pos, m.start(), False
                yield m.start(), m.end(), True
                pos = m.end()
        if pos < len(text):
            yield pos, len(text), False

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for a, b, added in self._spans(self._raw_re, text):
            if added:
                ids.append(self.added[text[a:b]][0])
            else:
                self._encode_segment(text[a:b], a, ids)
        return ids

    # ------------------------------------------------------------- decode
    def _byte_level_decode(self, toks: List[str]) -> List[str]:
        out = bytearray()
        for tok in toks:
            if all(c in self._byte_dec for c in tok):
                out.extend(self._byte_dec[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        return [out.decode("utf-8", errors="replace")]

    def decode(self, ids: Sequence[int], skip_special_tokens=True) -> str:
        toks = []
        for t in ids:
            t = int(t)
            if t not in self._id_to_token or (skip_special_tokens
                                              and t in self._special_ids):
                continue
            toks.append(self._id_to_token[t])
        if self._decoders is None:
            return " ".join(toks)
        for step in self._decoders:
            toks = step(toks)
        return "".join(toks)


def _byte_fallback_decode(toks: List[str]) -> List[str]:
    """Runs of ``<0xNN>`` tokens become their UTF-8 text (or one U+FFFD per
    byte when the run is not valid UTF-8)."""
    out, run = [], bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in run)
            run.clear()
    for t in toks:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(tok: str, c: str, start: int, stop: int) -> str:
    a = 0
    while a < min(start, len(tok)) and tok[a] == c:
        a += 1
    b = len(tok)
    while len(tok) - b < stop and b > a and tok[b - 1] == c:
        b -= 1
    return tok[a:b]


class BPETokenizer(TokenizerFile):
    """The vendored byte-level BPE (the JAX package's ``BPETokenizer``), in
    plain Python.

    The file (``bpe_nav.json``: 1016 vocab entries, 751 merges, 9 added
    tokens) has no normalizer, a ByteLevel pre-tokenizer (GPT-2 split, no
    prefix space) and a BPE model without dropout or unk. Id layout comes
    from the file: <unk>=0 <s>=1 </s>=2 <PAD>=3, the 5 schema specials,
    then the byte alphabet and the merges.
    """

    def __init__(self, json_path: Optional[str] = None):
        if json_path is None:
            json_path = os.path.join(os.path.dirname(__file__),
                                     "bpe_nav.json")
        super().__init__(json_path)
        tid = self.token_to_id
        self.unk_id, self.bos_id = tid("<unk>"), tid("<s>")
        self.eos_id, self.pad_id = tid("</s>"), tid("<PAD>")
        self._special = {t: tid(t) for t in SPECIAL_TOKENS}
        self._special.update({"<s>": self.bos_id, "</s>": self.eos_id,
                              "<PAD>": self.pad_id})
        self.true_vocab_size = len(self)
        self.bos_token, self.eos_token, self.pad_token = "<s>", "</s>", "<PAD>"

    def special_token_id(self, tok: str) -> int:
        return self._special[tok]


# the special-token attributes of tokenizer_config.json, in transformers'
# order (its tokenizer adds those not yet added tokens at load time)
_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                  "pad_token", "cls_token", "mask_token")
_LLAMA_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast")


def _token_content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


def _sentencepiece_file(path: Path, conf: Dict[str, object]
                        ) -> TokenizerFile:
    """``path/tokenizer.model`` as the fast tokenizer transformers builds
    from it (a slow ``LlamaTokenizer`` converted by ``LlamaConverter``),
    with the slow class's defaults: ``legacy`` None reads as True and an
    absent ``add_prefix_space`` as True."""
    from .sentencepiece import llama_tokenizer_spec, load_model
    cls = conf.get("tokenizer_class")
    if cls not in (None, *_LLAMA_CLASSES):
        raise ValueError(f"{path} holds a sentencepiece tokenizer.model "
                         f"and no tokenizer.json, for a {cls}: only "
                         f"LlamaTokenizer's layout is read")
    legacy = conf.get("legacy")
    model = path / "tokenizer.model"
    spec = llama_tokenizer_spec(load_model(model),
                                legacy=True if legacy is None else legacy,
                                add_prefix_space=conf.get("add_prefix_space",
                                                          True))
    return TokenizerFile(spec, where=str(model))


class HFTokenizer:
    """An HF tokenizer directory (``tokenizer.json``, or a sentencepiece
    ``tokenizer.model`` of a ``LlamaTokenizer``, and
    ``tokenizer_config.json``) with the schema special tokens: the port's
    twin of the JAX package's ``HFTokenizer``, which loads the same
    directory through ``transformers.AutoTokenizer`` (use_fast, left
    padding and truncation; a ``tokenizer.model`` converted to the fast
    tokenizer by ``LlamaConverter``).

    As that does: the config's special tokens (bos, eos, unk, pad, ...) not
    yet added tokens are added as special ones; ``SPECIAL_TOKENS`` are added
    as additional special tokens (a token already in the vocabulary keeps
    its id, a new one takes the next); ``<PAD>`` is added when the config
    names no pad token. ``unk_id`` falls back to ``pad_id`` when there is no
    unk token; ``true_vocab_size`` counts the added tokens. ``encode`` adds
    no special tokens; ``decode`` drops the special ones when asked and does
    not clean up spaces.
    """

    def __init__(self, pretrained_model_name_or_path):
        path = Path(pretrained_model_name_or_path)
        conf: Dict[str, object] = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            if (path / name).exists():
                conf.update(json.loads((path / name).read_text()))
        llama = conf.get("tokenizer_class") in _LLAMA_CLASSES
        if (path / "tokenizer.json").exists():
            self.tok = TokenizerFile(path / "tokenizer.json")
        elif (path / "tokenizer.model").exists():
            self.tok = _sentencepiece_file(path, conf)
            llama = True
        else:
            raise FileNotFoundError(f"no tokenizer.json or tokenizer.model "
                                    f"in {path}")
        if llama:
            for k, v in (("bos_token", "<s>"), ("eos_token", "</s>"),
                         ("unk_token", "<unk>")):
                conf.setdefault(k, v)
        named = {k: _token_content(conf.get(k)) for k in _SPECIAL_ATTRS}
        extra = [_token_content(t) for t in
                 conf.get("additional_special_tokens") or []]
        self.tok.add_special_tokens([
            t for t in [*named.values(), *extra]
            if t is not None and t not in self.tok.added])
        self.tok.add_special_tokens(SPECIAL_TOKENS)
        if named["pad_token"] is None:
            self.tok.add_special_tokens(["<PAD>"])
            named["pad_token"] = "<PAD>"

        def tid(tok):
            return None if tok is None else self.tok.token_to_id(tok)
        self.bos_id = tid(named["bos_token"])
        self.eos_id = tid(named["eos_token"])
        self.pad_id = tid(named["pad_token"])
        unk = tid(named["unk_token"])
        self.unk_id = unk if unk is not None else self.pad_id
        self.true_vocab_size = len(self.tok)
        self.bos_token = named["bos_token"]
        self.eos_token = named["eos_token"]
        self.pad_token = named["pad_token"]

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text)

    def decode(self, ids, skip_special_tokens=True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def special_token_id(self, tok: str) -> int:
        return self.tok.token_to_id(tok)


# BertTokenizer's special tokens, by attribute
_BERT_SPECIALS = (("unk_token", "[UNK]"), ("sep_token", "[SEP]"),
                  ("pad_token", "[PAD]"), ("cls_token", "[CLS]"),
                  ("mask_token", "[MASK]"))
# transformers' clean-up of spaces (clean_up_tokenization), and the one the
# WordPiece decoder applies to each token
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
             (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
             (" 've", "'ve"), (" 're", "'re"))
_WORDPIECE_CLEAN_UP = _CLEAN_UP[:7] + ((" do not", " don't"),) \
    + _CLEAN_UP[7:]


def _replace_all(text: str, pairs) -> str:
    for old, new in pairs:
        text = text.replace(old, new)
    return text


class WordPieceDecoder:
    """``decode(ids, skip_special_tokens=True)`` of a BERT fast tokenizer
    loaded from a directory (a Hugging Face snapshot of bert-base-uncased)
    by ``transformers.AutoTokenizer``, in plain Python.

    The vocabulary is ``tokenizer.json``'s WordPiece model when the
    directory has one, else ``vocab.txt`` (a token per line, the line its
    id). The special tokens are BERT's ``[UNK] [SEP] [PAD] [CLS] [MASK]``
    unless ``tokenizer_config.json`` names others, with its additional ones
    and those ``tokenizer.json`` flags special. Decoding drops unknown ids
    and the special tokens, joins the
    tokens as the WordPiece decoder does (a ``##`` piece glued to the one
    before it, any other token after a space, each token cleaned of a space
    before punctuation and contractions), then applies transformers'
    ``clean_up_tokenization`` when the tokenizer cleans up: as the config
    says, else when built from ``vocab.txt`` (BertTokenizer's default) and
    not when read from ``tokenizer.json``.
    """

    def __init__(self, directory):
        path = Path(directory)
        conf: Dict[str, object] = {}
        if (path / "tokenizer_config.json").exists():
            conf = json.loads((path / "tokenizer_config.json").read_text())
        added: Dict[int, Tuple[str, bool]] = {}
        self.prefix, self.cleanup = "##", True
        if (path / "tokenizer.json").exists():
            where = path / "tokenizer.json"
            spec = json.loads(where.read_text(encoding="utf-8"))
            dec = spec.get("decoder") or {}
            if spec["model"].get("type") != "WordPiece" \
                    or dec.get("type") != "WordPiece":
                raise ValueError(f"{where}: not a WordPiece model and "
                                 f"decoder")
            vocab = spec["model"]["vocab"]
            self.prefix = dec.get("prefix", "##")
            self.cleanup = bool(dec.get("cleanup", True))
            for t in spec.get("added_tokens", []):
                added[t["id"]] = (t["content"], bool(t.get("special")))
            clean_up = False
        elif (path / "vocab.txt").exists():
            vocab = {}
            with open(path / "vocab.txt", encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
            clean_up = True
        else:
            raise FileNotFoundError(f"no tokenizer.json or vocab.txt in "
                                    f"{path}")
        self.clean_up = bool(conf.get("clean_up_tokenization_spaces",
                                      clean_up))
        self._id_to_token = {i: t for t, i in vocab.items()}
        self._id_to_token.update({i: t for i, (t, _) in added.items()})
        self._special = {t for t, s in added.values() if s}
        self._special.update(
            _token_content(conf.get(k, v)) for k, v in _BERT_SPECIALS)
        self._special.update(_token_content(t) for t in
                             conf.get("additional_special_tokens") or [])
        self._special.discard(None)

    def __call__(self, ids: Sequence[int], skip_special_tokens=True) -> str:
        toks = [self._id_to_token[i] for i in map(int, ids)
                if i in self._id_to_token]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self._special]
        out = []
        for i, t in enumerate(toks):
            if i:
                t = t[len(self.prefix):] if t.startswith(self.prefix) \
                    else " " + t
            out.append(_replace_all(t, _WORDPIECE_CLEAN_UP)
                       if self.cleanup else t)
        text = "".join(out)
        return _replace_all(text, _CLEAN_UP) if self.clean_up else text


class NavTokenizer:
    """Schema-aware tokenizer with bucketed left padding."""

    # prompts longer than this bypass the encode cache (near-unique keys
    # that would only evict useful entries)
    _ENCODE_CACHE_MAX_CHARS = 4096

    def __init__(self,
                 backend: Union[ByteTokenizer, BPETokenizer, HFTokenizer,
                                None] = None,
                 max_length: int = 1024, pad_to_multiple: int = 64):
        self.backend = backend or ByteTokenizer()
        self.max_length = max_length
        self.pad_to_multiple = pad_to_multiple

        b = self.backend
        self.bos_id, self.eos_id = b.bos_id, b.eos_id
        self.pad_id, self.unk_id = b.pad_id, b.unk_id
        self.bos_token, self.eos_token = b.bos_token, b.eos_token
        self.cand_id = b.special_token_id("<cand>")
        self.hist_id = b.special_token_id("<hist>")
        self.obj_id = b.special_token_id("<obj>")
        self.cls_ids = [b.special_token_id("<cls_1>"), b.special_token_id("<cls_2>")]
        self.special_token_ids = [self.cand_id, self.hist_id, self.obj_id] + self.cls_ids
        self.true_vocab_size = b.true_vocab_size
        self.vocab_size = _round_up(self.true_vocab_size, 128)
        # per-instance encode LRU: navigation prompts repeat heavily (the
        # same instruction is re-tokenized every rollout step); values are
        # immutable tuples so cache hits cannot be corrupted by callers
        self._encode_cached = functools.lru_cache(maxsize=8192)(
            self._encode_uncached)

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "NavTokenizer":
        """An HF tokenizer directory (``tokenizer.json``, or LLaMA's
        ``tokenizer.model``), read by HFTokenizer."""
        return cls(HFTokenizer(path), **kw)

    @classmethod
    def bpe(cls, json_path: Optional[str] = None, **kw) -> "NavTokenizer":
        """The vendored hermetic subword tokenizer (BPETokenizer), the
        JAX package's default for benches and end-to-end paths."""
        return cls(BPETokenizer(json_path), **kw)

    def _encode_uncached(self, text: str, add_bos: bool) -> tuple:
        ids = self.backend.encode(text)
        return tuple([self.bos_id] + ids) if add_bos else tuple(ids)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        if len(text) > self._ENCODE_CACHE_MAX_CHARS:
            return list(self._encode_uncached(text, add_bos))
        return list(self._encode_cached(text, add_bos))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(t) for t in ids if int(t) != self.pad_id]
        return self.backend.decode(ids, skip_special_tokens=skip_special_tokens)

    def special_logit_mask(self) -> np.ndarray:
        """[vocab_size] bool: True for columns to force to -inf (schema
        specials + alignment-padding rows)."""
        mask = np.zeros(self.vocab_size, dtype=bool)
        mask[self.special_token_ids] = True
        mask[self.true_vocab_size:] = True
        return mask

    def _bucket_len(self, longest: int) -> int:
        return min(self.max_length, _round_up(max(longest, 1), self.pad_to_multiple))

    def __call__(self, texts: Sequence[Union[str, Tuple[str, str], List[str]]],
                 pad_to: Optional[int] = None) -> TokenBatch:
        """Tokenize strings or [prompt, answer] pairs.

        Left-truncates to max_length, left-pads to a shared bucketed
        length. token_type_ids are 1 on answer tokens (0 elsewhere).
        """
        seqs: List[List[int]] = []
        types: List[List[int]] = []
        for t in texts:
            if isinstance(t, (tuple, list)):
                prompt, answer = t
                p_ids = self.encode(prompt, add_bos=True)
                a_ids = self.encode(answer, add_bos=False)
                seqs.append(p_ids + a_ids)
                types.append([0] * len(p_ids) + [1] * len(a_ids))
            else:
                p_ids = self.encode(t, add_bos=True)
                seqs.append(p_ids)
                types.append([0] * len(p_ids))
        seqs = [s[-self.max_length:] for s in seqs]
        types = [ty[-self.max_length:] for ty in types]
        longest = max(len(s) for s in seqs)
        length = pad_to if pad_to is not None else self._bucket_len(longest)

        bsz = len(seqs)
        input_ids = np.full((bsz, length), self.pad_id, dtype=np.int32)
        attn = np.zeros((bsz, length), dtype=bool)
        tty = np.zeros((bsz, length), dtype=np.int32)
        for i, (s, ty) in enumerate(zip(seqs, types)):
            input_ids[i, length - len(s):] = s
            attn[i, length - len(s):] = True
            tty[i, length - len(s):] = ty
        return TokenBatch(input_ids, attn, tty)
