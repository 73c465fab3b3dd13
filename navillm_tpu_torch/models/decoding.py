"""Autoregressive generation: one prefill, then a KV-cache decode loop.

Torch twin of navillm_tpu/models/decoding.py. The visual embeds are
injected at the prefill only; the prompt is left-padded to a multiple of
``prompt_bucket`` (the JAX bucketing, kept so both packages run the same
widths), forwarded once by forward_hidden(return_kv=True) (the flash
kernel on the card), and its K/V (int8 with ``kv_int8``, quantized once
after the prefill) stay read-only while a Python loop runs
one decode_step per token against them and a decode region written in
place. Tokens stay on the device: the loop syncs with the host only to
ask, every ``STOP_CHECK`` steps, whether every row has finished, after
which every further output is the pad id, so stopping then gives JAX's
output. Greedy picks are the first maximum, as ``jnp.argmax``; sampled
ones a Gumbel-max draw from a torch.Generator (jax.random.categorical
cannot be replayed). The EQA answers run under the DenseTrie constraint
(models/trie.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import llama as L
from .trie import DenseTrie
from ..ops.masking import NEG_INF

# decode steps between two checks of "every row has finished" (each check
# is one host sync)
STOP_CHECK = 8


def _device_of(params) -> torch.device:
    embed = params["embed"]
    return (embed if isinstance(embed, torch.Tensor) else embed["q"]).device


def pick_token(logits, trie_state, special_token_mask, trie, do_sample,
               temperature, generator):
    """The next token per row: specials, then the trie's disallowed tokens
    at NEG_INF, then argmax or a draw. Returns int32 [B]."""
    logits = logits.float()
    if special_token_mask is not None:
        logits = logits.masked_fill(special_token_mask, NEG_INF)
    if trie is not None:
        allowed = trie.logits_mask(trie_state, logits.shape[-1])
        logits = logits.masked_fill(~allowed, NEG_INF)
    if do_sample:
        z = logits / max(float(temperature), 1e-6)
        u = torch.rand(z.shape, generator=generator, device=z.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        logits = z - torch.log(-torch.log(u))
    return logits.argmax(-1).int()


def bucket_prompt(input_ids, attention_mask, inject_positions, pad_id: int,
                  prompt_bucket: int = 64):
    """Left-pad [B, T] prompts (numpy) to a multiple of prompt_bucket and
    shift the inject positions [B, K] (-1 unused) by the same amount."""
    input_ids = np.asarray(input_ids)
    attention_mask = np.asarray(attention_mask, bool)
    extra = -input_ids.shape[1] % prompt_bucket
    if extra:
        input_ids = np.pad(input_ids, ((0, 0), (extra, 0)),
                           constant_values=pad_id)
        attention_mask = np.pad(attention_mask, ((0, 0), (extra, 0)))
    if inject_positions is not None:
        ip = np.asarray(inject_positions)
        inject_positions = np.where(ip >= 0, ip + extra, -1)
    return input_ids, attention_mask, inject_positions


def prefill(params, cfg: L.LlamaConfig, ids, mask, inject_positions=None,
            inject_embeds=None):
    """One forward over bucketed prompts (tensors on the params' device)
    with the visual embeds added: (the last position's logits [B, vocab]
    in f32, unmasked; the prompt K/V {"k", "v"} [L, B, T, NKV, D])."""
    x = L.embed_with_injection(params, ids, inject_positions, inject_embeds)
    hidden, prompt_kv = L.forward_hidden(params, cfg, x, mask, return_kv=True)
    last = L.lm_head(params, cfg, hidden[:, -1])
    return last.float(), prompt_kv


def generate(params, cfg: L.LlamaConfig, input_ids, attention_mask, *,
             inject_positions=None, inject_embeds=None,
             special_token_mask=None, eos_id: int, pad_id: int,
             max_new_tokens: int, do_sample: bool = False,
             temperature: float = 1.0,
             generator: Optional[torch.Generator] = None,
             trie: Optional[DenseTrie] = None,
             prompt_bucket: int = 64, kv_int8: bool = False
             ) -> torch.Tensor:
    """Generated token ids [B, max_new_tokens] int32 on the params' device
    (pad after eos).

    input_ids / attention_mask: [B, T] left-padded prompts (numpy);
    inject_positions [B, K] (-1 unused) and inject_embeds [B, K, H] are
    added at the prefill; special_token_mask [vocab] bool. kv_int8: the
    prompt K/V is kept int8 (llama.quantize_kv_stack) after the prefill,
    and each decode step reads it dequantized.
    """
    dev = _device_of(params)
    ids, mask, inject_positions = bucket_prompt(
        input_ids, attention_mask, inject_positions, pad_id, prompt_bucket)
    if inject_positions is not None:
        inject_positions = torch.as_tensor(inject_positions, device=dev)
        inject_embeds = torch.as_tensor(inject_embeds, device=dev)
    if special_token_mask is not None:
        special_token_mask = torch.as_tensor(special_token_mask, device=dev)
    ids = torch.as_tensor(ids, device=dev).long()
    mask = torch.as_tensor(mask, device=dev)
    b = ids.shape[0]
    tp = L.tp_group(params)

    def same_draw(t):
        """A sharded tree's ranks draw alike (same generator, same
        gathered logits); rank 0's draw is broadcast all the same."""
        return tp.broadcast(t) if do_sample and tp is not None else t

    pick = dict(special_token_mask=special_token_mask, trie=trie,
                do_sample=do_sample, temperature=temperature,
                generator=generator)
    with torch.inference_mode():
        logits, prompt_kv = prefill(params, cfg, ids, mask, inject_positions,
                                    inject_embeds)
        if kv_int8:
            prompt_kv = L.quantize_kv_stack(prompt_kv)
        state = torch.zeros((b,), dtype=torch.int32, device=dev)
        tok = same_draw(pick_token(logits, state, **pick))
        done = tok == eos_id
        outs = [tok[:, None]]
        prompt_lens = mask.sum(-1)
        dec_cache = L.init_decode_cache(cfg, b, max_new_tokens, dev,
                                        L.local_heads(params, cfg)[1])
        for i in range(max_new_tokens - 1):
            if i % STOP_CHECK == 0 and i and bool(done.all()):
                outs.append(torch.full((b, max_new_tokens - 1 - i), pad_id,
                                       dtype=torch.int32, device=dev))
                break
            emb = L.embed_rows(params["embed"], tok.long(),
                               L.tp_group(params))[:, None, :]
            hidden, dec_cache = L.decode_step(
                params, cfg, emb, prompt_kv, mask, dec_cache, i,
                (prompt_lens + i)[:, None])
            logits = L.lm_head(params, cfg, hidden[:, -1])
            if trie is not None:
                state = trie.advance(state, tok)
            nxt = same_draw(pick_token(logits, state, **pick))
            outs.append(torch.where(done, pad_id, nxt).int()[:, None])
            done = done | (nxt == eos_id)
            tok = nxt
        return torch.cat(outs, dim=1)


def decode_to_text(tokenizer, generated_ids) -> list:
    """Host side: each row up to its eos, pads dropped, decoded."""
    out = []
    for row in np.asarray(generated_ids):
        ids = []
        for t in row:
            if int(t) == tokenizer.eos_id:
                break
            if int(t) != tokenizer.pad_id:
                ids.append(int(t))
        out.append(tokenizer.decode(ids))
    return out
