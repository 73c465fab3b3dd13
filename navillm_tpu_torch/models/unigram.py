"""The ``Unigram`` model of a fast-tokenizer ``tokenizer.json`` in plain
Python, as the ``tokenizers`` package runs it.

A sentencepiece Unigram model (``model_type`` 1) converts to this model:
transformers' ``SpmConverter`` builds ``Unigram(vocab_scores, unk_id,
byte_fallback)``, which ``tokenizer.json`` holds as ``vocab`` ([piece,
score] by id), ``unk_id`` and ``byte_fallback``. Encoding a pre-token is a
Viterbi search over its characters: every vocabulary piece that starts at a
position extends the best path that ends there by its score; a position
that no one-character piece covers may be crossed by the unknown token at
the lowest score less 10. The best path is read backwards, consecutive
unknowns fused into one string (the library builds the model with
``fuse_unk`` on), and each string becomes its id, its UTF-8 bytes'
``<0xNN>`` pieces (``byte_fallback``) or ``unk_id``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# what the library subtracts from the lowest score for an unknown character
UNK_PENALTY = 10.0


class UnigramModel:
    """``tokenize(word)``: the ids of one pre-token; ``vocab``: piece ->
    id (a piece listed twice keeps its last id, as the library's map
    does); ``id_to_token``: id -> piece."""

    def __init__(self, spec: dict, where: str):
        pairs = spec["vocab"]
        if not pairs:
            raise ValueError(f"{where}: a Unigram model with no vocabulary")
        self.pieces = [p for p, _ in pairs]
        self.scores = [float(s) for _, s in pairs]
        self.vocab: Dict[str, int] = {p: i for i, p in enumerate(self.pieces)}
        self.id_to_token = dict(enumerate(self.pieces))
        self.unk_id: Optional[int] = spec.get("unk_id")
        if self.unk_id is not None and not 0 <= self.unk_id < len(pairs):
            raise ValueError(f"{where}: unk_id {self.unk_id} is not in the "
                             f"vocabulary")
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.max_len = max(len(p) for p in self.pieces)

    def _unk(self) -> int:
        if self.unk_id is None:
            raise ValueError("a character is not in the Unigram vocabulary "
                             "and the model has no unk_id")
        return self.unk_id

    def segment(self, word: str) -> List[str]:
        """The best path's strings, unknowns fused."""
        n = len(word)
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        vocab, scores = self.vocab, self.scores
        for i in range(n):
            base = best[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = vocab.get(word[i:j])
                if tid is None:
                    continue
                score = scores[tid] + base
                if start[j] < 0 or score > best[j]:
                    best[j], start[j], ids[j] = score, i, tid
                single = single or j == i + 1
            if not single:
                score = self.unk_score + base
                if start[i + 1] < 0 or score > best[i + 1]:
                    best[i + 1], start[i + 1], ids[i + 1] = \
                        score, i, self._unk()
        out: List[str] = []
        unks: List[str] = []
        j = n
        while j > 0:
            i = start[j]
            if self.unk_id is not None and ids[j] == self.unk_id:
                unks.append(word[i:j])
            else:
                if unks:
                    out.append("".join(reversed(unks)))
                    unks = []
                out.append(word[i:j])
            j = i
        if unks:
            out.append("".join(reversed(unks)))
        return out[::-1]

    def tokenize(self, word: str) -> Tuple[int, ...]:
        if not word:
            return ()
        ids: List[int] = []
        for s in self.segment(word):
            tid = self.vocab.get(s)
            if tid is None:
                if self.byte_fallback:
                    codes = [self.vocab.get(f"<0x{b:02X}>")
                             for b in s.encode("utf-8")]
                    if None not in codes:
                        ids.extend(codes)
                        continue
                tid = self._unk()
            ids.append(tid)
        return tuple(ids)
