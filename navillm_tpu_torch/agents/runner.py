"""NavModelRunner: the device entry points of the streaming evaluator.

Torch twin of the surface of navillm_tpu/agents/runner.py that greedy
R2R streaming evaluation uses: ``cfg``, ``tok``, ``dims``,
``device_memory``, ``memory_init``, ``eval_step``,
``tokenize_with_positions``, ``prefix_cache_enabled`` and the
``llm_token_units`` counter. Host arrays go up through pinned buffers
with non-blocking copies, so uploading one slot group's step never waits
for the other group's step running on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from navillm_tpu.models.tokenization import NavTokenizer

from ..models.nav_model import NavModel, NavModelConfig
from . import device_memory as DM

# device graph-memory node capacity (ids beyond it are not memorized)
MEM_CAPACITY = 256


@dataclasses.dataclass(frozen=True)
class RolloutDims:
    """Static padded sizes of the rollout's device batches."""
    max_gmap_nodes: int = 160
    max_views: int = 44
    max_cands: int = 99
    max_hist: int = 32

    @classmethod
    def tiny(cls) -> "RolloutDims":
        return cls(max_gmap_nodes=16, max_views=40, max_cands=8, max_hist=8)


class HostCopy:
    """A device tensor's download, started at once: a non-blocking copy
    into pinned memory plus a CUDA event. ``result()`` waits for the event
    only. On CPU tensors it is the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf = t

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


class NavModelRunner:
    def __init__(self, cfg: NavModelConfig, model: NavModel,
                 tokenizer: NavTokenizer, dims: RolloutDims = RolloutDims(),
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.model = model
        self.tok = tokenizer
        self.dims = dims
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self.device_memory = True
        # UNPADDED (mask-summed) token count forwarded through the LLM
        self.llm_token_units = 0.0
        # fused eval steps dispatched (each runs every LLM layer once)
        self.eval_steps = 0

    def upload(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Host array -> device tensor without a stream sync (pinned,
        non-blocking on CUDA); ``dtype`` casts on the host first."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def memory_init(self, batch: int, capacity: int = None):
        return DM.init_memory(batch, capacity or MEM_CAPACITY,
                              self.dims.max_hist, self.cfg.hidden_size,
                              torch.float32, self.device)

    def prefix_cache_enabled(self, batch: int, max_prefix: int,
                             n_caches: int = 1, kv_int8: bool = False) -> bool:
        """The prefix-cached step is not ported yet."""
        return False

    def eval_step(self, state, pano_inputs: Dict, batch: Dict, reset_mask,
                  cur_ids, cand_ids, active_mask, a_t_override=None,
                  do_sample: bool = False, sync: bool = True):
        """ONE device call per streaming-eval step (reset -> pano -> memory
        update -> nav forward -> argmax -> hist append). pano_inputs'
        view_img_fts may already be a device tensor. Returns (new_state,
        a_t, logits [B, G] on device); a_t is a numpy array, or with
        sync=False the device tensor, so the caller can overlap host work
        with the step and download a_t later (HostCopy)."""
        if do_sample:
            raise NotImplementedError("sampled decoding is not ported")
        if a_t_override is None:
            a_t_override = np.full(len(cur_ids), -1, np.int32)
        view = pano_inputs["view_img_fts"]
        pano = {"view_img_fts": view if torch.is_tensor(view)
                else self.upload(view),
                **{k: self.upload(pano_inputs[k])
                   for k in ("view_lens", "loc_fts", "nav_types")}}
        dev = {k: self.upload(v) for k, v in batch.items()}
        self.llm_token_units += float(np.asarray(batch["attention_mask"]).sum())
        self.eval_steps += 1
        with torch.inference_mode():
            state, a_t, logits = DM.eval_step(
                self.model, self.cfg, state, pano, dev,
                self.upload(reset_mask), self.upload(cur_ids),
                self.upload(cand_ids), self.upload(active_mask),
                self.upload(np.asarray(a_t_override, np.int32)))
        return state, (HostCopy(a_t).result() if sync else a_t), logits

    def tokenize_with_positions(self, texts, max_cands: Optional[int] = None,
                                max_hist: Optional[int] = None):
        """Tokenize prompts and extract end-aligned positions of the
        <cand>/<hist>/<cls_1> tokens. Returns (TokenBatch, cand_positions
        [B,C], hist_positions [B,Hh], cls_pos [B]), -1 padded."""
        C = max_cands if max_cands is not None else self.dims.max_cands
        Hh = max_hist if max_hist is not None else self.dims.max_hist
        batch = self.tok(texts)
        ids = batch.input_ids
        b, _ = ids.shape
        cand_pos = np.full((b, C), -1, np.int32)
        hist_pos = np.full((b, Hh), -1, np.int32)
        cls_pos = np.zeros((b,), np.int32)
        for i in range(b):
            cpos = np.where(ids[i] == self.tok.cand_id)[0]
            hpos = np.where(ids[i] == self.tok.hist_id)[0]
            cand_pos[i, : min(len(cpos), C)] = cpos[-C:]
            hist_pos[i, : min(len(hpos), Hh)] = hpos[-Hh:]
            cls = np.where(ids[i] == self.tok.cls_ids[0])[0]
            cls_pos[i] = cls[-1] if len(cls) else ids.shape[1] - 1
        return batch, cand_pos, hist_pos, cls_pos
