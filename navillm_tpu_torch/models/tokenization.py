"""Tokenizer adapter: the hermetic byte tokenizer and the vendored BPE.

The port's copy of ``TokenBatch``, ``ByteTokenizer``, ``BPETokenizer`` and
``NavTokenizer`` from navillm_tpu/models/tokenization.py, with the same
names, ids and masks. It keeps the reference's tokenizer contract
(models/modified_lm.py:56-87):
  - special tokens `<cand> <hist> <obj> <cls_1> <cls_2>` (+ `<PAD>`),
  - left padding and left truncation at max_length=1024,
  - pair encoding [prompt, answer] with token_type_ids 0/1 used for
    label masking (nav_model.py:305-316).
Batches pad to a bucketed static length (a multiple of
``pad_to_multiple``), and the embedding table is sized up to a multiple
of 128 (ids >= the true vocab are masked in the logits).

``BPETokenizer`` reads the port's own copy of ``bpe_nav.json`` and
encodes it in plain Python, without the ``tokenizers`` package (which the
card's machine lacks): the byte-level BPE of that file, with the GPT-2
split written out over ``str``. The HF Llama tokenizer needs
``transformers``, so ``NavTokenizer.from_pretrained`` raises.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

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


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (the ByteLevel alphabet):
    printable Latin-1 bytes map to themselves, the other 68 to U+0100..."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# what the split regex's \s matches: Unicode White_Space. str.isspace also
# takes U+001C..U+001F (bidi class B/S), which the regex reads as
# punctuation
_NOT_WS = frozenset("\x1c\x1d\x1e\x1f")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=65536)
def _char_class(c: str) -> str:
    """'s' (whitespace), 'L' (letter), 'N' (number) or 'P' (anything else),
    as the split regex's \\s, \\p{L} and \\p{N} read it."""
    if c.isspace() and c not in _NOT_WS:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "P"


def gpt2_split(text: str) -> List[str]:
    """The ByteLevel pre-tokenizer's split (use_regex, no prefix space):
    the pieces the pattern
      's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
    matches, left to right, its alternatives tried in order."""
    n = len(text)
    cls = [_char_class(c) for c in text]
    out = []
    i = 0
    while i < n:
        c = text[i]
        if c == "'":
            hit = next((w for w in _CONTRACTIONS
                        if text.startswith(w, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # ` ?X+` for X in letters, numbers, other: an optional U+0020, then a
        # run of one class
        j = i + 1 if c == " " and i + 1 < n and cls[i + 1] != "s" else i
        k = cls[j] if j < n else "s"
        if k != "s":
            e = j + 1
            while e < n and cls[e] == k:
                e += 1
            out.append(text[i:e])
            i = e
            continue
        # whitespace: \s+(?!\S) keeps the run's last character for the next
        # piece when a non-space follows; a lone one falls to \s+
        e = i + 1
        while e < n and cls[e] == "s":
            e += 1
        if e < n and e - i > 1:
            e -= 1
        out.append(text[i:e])
        i = e
    return out


class BPETokenizer:
    """The vendored byte-level BPE (the JAX package's ``BPETokenizer``),
    in plain Python.

    The file (``bpe_nav.json``: 1016 vocab entries, 751 merges, 9 added
    tokens) has no normalizer, a ByteLevel pre-tokenizer (GPT-2 split, no
    prefix space) and a BPE model without dropout or unk. Encoding: the
    added tokens are split out of the text first, literally (longest
    first; they are never normalized or split); every other segment is
    split by ``gpt2_split``, each piece's UTF-8 bytes are mapped through
    ``bytes_to_unicode`` and merged by rank (lowest first), with a
    per-piece cache. Decoding maps the tokens' characters back to bytes
    (lossy UTF-8, as the ByteLevel decoder) and skips the special ids
    when asked.

    Id layout comes from the file: <unk>=0 <s>=1 </s>=2 <PAD>=3, the 5
    schema specials, then the byte alphabet and the merges.
    """

    def __init__(self, json_path: Optional[str] = None):
        if json_path is None:
            json_path = os.path.join(os.path.dirname(__file__),
                                     "bpe_nav.json")
        with open(json_path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "BPE" or model.get("dropout") \
                or spec["pre_tokenizer"].get("type") != "ByteLevel" \
                or spec["pre_tokenizer"].get("add_prefix_space") \
                or spec.get("normalizer") is not None:
            raise ValueError(f"{json_path}: not the byte-level BPE layout "
                             f"this tokenizer implements")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ranks = {tuple(m.split(" ") if isinstance(m, str) else m): r
                      for r, m in enumerate(model["merges"])}
        self.added = {t["content"]: t["id"] for t in spec["added_tokens"]}
        self._special_ids = {t["id"] for t in spec["added_tokens"]
                             if t.get("special")}
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        self._id_to_token.update({i: t for t, i in self.added.items()})
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._added_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
        self._piece_ids = functools.lru_cache(maxsize=65536)(self._bpe)

        tid = self.token_to_id
        self.unk_id, self.bos_id = tid("<unk>"), tid("<s>")
        self.eos_id, self.pad_id = tid("</s>"), tid("<PAD>")
        self._special = {t: tid(t) for t in SPECIAL_TOKENS}
        self._special.update({"<s>": self.bos_id, "</s>": self.eos_id,
                              "<PAD>": self.pad_id})
        self.true_vocab_size = len(self._id_to_token)
        self.bos_token, self.eos_token, self.pad_token = "<s>", "</s>", "<PAD>"

    def token_to_id(self, tok: str) -> int:
        return self.added[tok] if tok in self.added else self.vocab[tok]

    def _bpe(self, piece: str) -> Tuple[int, ...]:
        """Ids of one pre-token: its byte characters merged by rank."""
        word = [self._byte_enc[b] for b in piece.encode("utf-8")]
        ranks = self.ranks
        while len(word) > 1:
            best = min(range(len(word) - 1),
                       key=lambda j: ranks.get((word[j], word[j + 1]),
                                               len(ranks)))
            pair = (word[best], word[best + 1])
            if pair not in ranks:
                break
            merged, j = [], 0
            while j < len(word):
                if j < len(word) - 1 and (word[j], word[j + 1]) == pair:
                    merged.append(pair[0] + pair[1])
                    j += 2
                else:
                    merged.append(word[j])
                    j += 1
            word = merged
        return tuple(self.vocab[t] for t in word)

    def _encode_segment(self, text: str, out: List[int]):
        for piece in gpt2_split(text):
            out.extend(self._piece_ids(piece))

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            if m.start() > pos:
                self._encode_segment(text[pos:m.start()], ids)
            ids.append(self.added[m.group()])
            pos = m.end()
        if pos < len(text):
            self._encode_segment(text[pos:], ids)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens=True) -> str:
        out = bytearray()
        for t in ids:
            t = int(t)
            if skip_special_tokens and t in self._special_ids:
                continue
            tok = self._id_to_token[t]
            if all(c in self._byte_dec for c in tok):
                out.extend(self._byte_dec[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        return out.decode("utf-8", errors="replace")

    def special_token_id(self, tok: str) -> int:
        return self._special[tok]


class NavTokenizer:
    """Schema-aware tokenizer with bucketed left padding."""

    # prompts longer than this bypass the encode cache (near-unique keys
    # that would only evict useful entries)
    _ENCODE_CACHE_MAX_CHARS = 4096

    def __init__(self,
                 backend: Union[ByteTokenizer, BPETokenizer, None] = None,
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
        raise NotImplementedError(
            "NavTokenizer.from_pretrained needs the HF tokenizer "
            "(transformers), which the port does not have yet; use the byte "
            "tokenizer, NavTokenizer()")

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
