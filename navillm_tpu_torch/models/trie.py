"""Closed-vocabulary trie as a dense device-side automaton.

Torch twin of navillm_tpu/models/trie.py: the trie over the answers' token
sequences is flattened once into dense tables, so the per-step constraint
of a decode loop is a gather on the device, with no host sync:

  children_tokens [N, C] int32: token ids of node n's children (-1 padded)
  children_next   [N, C] int32: child node index for each slot
  is_leaf         [N]    bool:  no children -> only eos is allowed

At a leaf the allowed set is {eos} and the state stays put.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch


class DenseTrie:
    def __init__(self, sequences: Sequence[Sequence[int]], eos_id: int,
                 device=None):
        self.eos_id = eos_id
        children: List[dict] = [{}]
        for seq in sequences:
            cur = 0
            for tok in seq:
                tok = int(tok)
                nxt = children[cur].get(tok)
                if nxt is None:
                    nxt = len(children)
                    children.append({})
                    children[cur][tok] = nxt
                cur = nxt
        n = len(children)
        width = max(1, max((len(c) for c in children), default=1))
        tok_tab = np.full((n, width), -1, dtype=np.int32)
        nxt_tab = np.zeros((n, width), dtype=np.int32)
        for i, c in enumerate(children):
            for j, (tok, nn) in enumerate(sorted(c.items())):
                tok_tab[i, j] = tok
                nxt_tab[i, j] = nn
        self.children_tokens = torch.from_numpy(tok_tab).to(device)
        self.children_next = torch.from_numpy(nxt_tab).to(device)
        self.is_leaf = torch.from_numpy(tok_tab[:, 0] < 0).to(device)
        self.num_nodes = n
        self.width = width
        # content fingerprint: two tries of the same vocabulary are
        # interchangeable
        h = hashlib.sha1()
        h.update(tok_tab.tobytes())
        h.update(nxt_tab.tobytes())
        h.update(str(eos_id).encode())
        self.fingerprint = h.hexdigest()

    def advance(self, state: torch.Tensor, token: torch.Tensor
                ) -> torch.Tensor:
        """state [B], token [B] -> new state [B] (leaf states stay)."""
        state = state.long()
        toks = self.children_tokens[state]          # [B, C]
        hit = toks == token[:, None]
        idx = hit.int().argmax(dim=1)               # first hit, as jnp.argmax
        nxt = self.children_next[state].gather(1, idx[:, None])[:, 0]
        stay = self.is_leaf[state] | ~hit.any(dim=1)
        return torch.where(stay, state.int(), nxt)

    def logits_mask(self, state: torch.Tensor, vocab_size: int
                    ) -> torch.Tensor:
        """state [B] -> [B, vocab] bool allowed mask (eos at leaves)."""
        state = state.long()
        b = state.shape[0]
        toks = self.children_tokens[state]          # [B, C]
        # max-scatter: a padding slot (-1, read as token 0) never clears a
        # real child 0
        mask = torch.zeros((b, vocab_size), dtype=torch.int32,
                           device=state.device).scatter_reduce_(
            1, toks.clamp(min=0).long(), (toks >= 0).int(), "amax") > 0
        leaf_row = torch.zeros((vocab_size,), dtype=torch.bool,
                               device=state.device)
        leaf_row[self.eos_id] = True
        return torch.where(self.is_leaf[state][:, None], leaf_row, mask)
