"""Tokenizer adapter on the hermetic byte path.

The port's copy of ``TokenBatch``, ``ByteTokenizer`` and ``NavTokenizer``
from navillm_tpu/models/tokenization.py, with the same names, ids and
masks. It keeps the reference's tokenizer contract (models/modified_lm.py:
56-87):
  - special tokens `<cand> <hist> <obj> <cls_1> <cls_2>` (+ `<PAD>`),
  - left padding and left truncation at max_length=1024,
  - pair encoding [prompt, answer] with token_type_ids 0/1 used for
    label masking (nav_model.py:305-316).
Batches pad to a bucketed static length (a multiple of
``pad_to_multiple``), and the embedding table is sized up to a multiple
of 128 (ids >= the true vocab are masked in the logits).

The subword backends (the vendored BPE and the HF Llama tokenizer) need
the ``tokenizers`` and ``transformers`` packages, which the card's
machine lacks; ``NavTokenizer.bpe`` and ``NavTokenizer.from_pretrained``
raise until the port has them.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import List, Optional, Sequence, Tuple, Union

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


class NavTokenizer:
    """Schema-aware tokenizer with bucketed left padding."""

    # prompts longer than this bypass the encode cache (near-unique keys
    # that would only evict useful entries)
    _ENCODE_CACHE_MAX_CHARS = 4096

    def __init__(self, backend: Optional[ByteTokenizer] = None,
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
        raise NotImplementedError(
            "NavTokenizer.bpe needs the `tokenizers` package, which the port "
            "does not have yet; use the byte tokenizer, NavTokenizer()")

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
