"""NavModelRunner: the device entry points of evaluation and training.

Torch twin of the surface of navillm_tpu/agents/runner.py that greedy
R2R streaming evaluation and fused teacher-forcing training use: ``cfg``,
``tok``, ``dims``, ``device_memory``, ``memory_init``, ``eval_step``,
``tokenize_with_positions``, the prefix cache (``prefix_cache_enabled``,
``prefix_cache_init``, ``prefill``, ``eval_step_cached``), the
``llm_token_units`` counter, and for training ``zero_grads`` /
``take_grads``, ``panorama_dev_dict``, ``replay_fuse_scan`` and
``pano_navigation_train``. Host arrays go up through pinned buffers with
non-blocking copies, so uploading one slot group's step never waits for
the other group's step running on the card.

Randomness: jax.random keys become torch.Generators. The runner draws one
seed per dropout-bearing call from its own host generator; a call seeded
the same way (the fused trainer's phase-2 panorama and its phase-5
recompute) draws the same dropout masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models import nav_model as NM
from ..models.nav_model import NavModel, NavModelConfig
from ..models.pano_encoder import dropout, forward_panorama
from ..models.quant import is_quantized
from ..models.tokenization import NavTokenizer
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
    # prompt-prefix KV cache capacity per slot (instruction + history
    # tokens; the cached streaming eval raises if a prefix outgrows it)
    max_prefix: int = 768

    @classmethod
    def tiny(cls) -> "RolloutDims":
        return cls(max_gmap_nodes=16, max_views=40, max_cands=8, max_hist=8,
                   max_prefix=448)


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
    PANO_KEYS = ("view_img_fts", "view_lens", "loc_fts", "nav_types")

    def __init__(self, cfg: NavModelConfig, model: NavModel,
                 tokenizer: NavTokenizer, dims: RolloutDims = RolloutDims(),
                 device: Optional[torch.device] = None,
                 feat_dropout: float = 0.4, ignore_id: int = -100,
                 seed: int = 0):
        if cfg.llm.act_int8 and not is_quantized(model):
            raise ValueError("act_int8 needs a quantized LLM: int8 "
                             "activations only run against quantized "
                             "weights (models/llama.py:_mm)")
        self.cfg = cfg
        self.model = model
        self.tok = tokenizer
        self.dims = dims
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self.device_memory = True
        self.feat_dropout = feat_dropout
        self.ignore_id = ignore_id
        self.rng = torch.Generator().manual_seed(seed)
        # True between zero_grads() and take_grads()
        self.grads_open = False
        # UNPADDED (mask-summed) token count forwarded through the LLM, in
        # forward-equivalents (a fwd+bwd call counts 3x its tokens)
        self.llm_token_units = 0.0
        # fused eval steps dispatched (each runs every LLM layer once over
        # the whole prompt)
        self.eval_steps = 0
        # prefix-cached eval steps (every layer over the [append | suffix]
        # window only) and prefix prefill calls (every layer over <= 8
        # prefixes)
        self.cached_steps = 0
        self.prefill_calls = 0
        # navigation loss+grad calls (each runs every LLM layer forward,
        # recomputed forward under remat, and backward)
        self.grad_calls = 0

    def upload(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Host array -> device tensor without a stream sync (pinned,
        non-blocking on CUDA); ``dtype`` casts on the host first."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def next_seed(self) -> int:
        """A fresh dropout seed from the runner's generator."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.rng))

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------- training --- #
    def zero_grads(self):
        """Open a gradient-accumulation window: every parameter trains and
        its .grad, kept in the parameter's dtype as the JAX accumulator is,
        starts at zero (buffers are reused from the last window)."""
        if is_quantized(self.model):
            raise ValueError("a quantized LLM is eval-only: int8 weights are "
                             "not differentiable (models/quant.py)")
        for p in self.model.parameters():
            p.requires_grad_(True)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        self.grads_open = True

    def take_grads(self) -> Dict[str, torch.Tensor]:
        """Close the window; {name: accumulated gradient} under the JAX
        names (the .grad tensors themselves, not copies)."""
        self.grads_open = False
        return {n: p.grad for n, p in self.model.named_parameters()}

    def _pano_dev_inputs(self, pano_inputs) -> Dict[str, torch.Tensor]:
        return {k: (v if torch.is_tensor(v) else self.upload(v))
                for k, v in pano_inputs.items() if k in self.PANO_KEYS}

    def pano_apply(self, pano_dev, generator: Optional[torch.Generator],
                   deterministic: bool) -> Dict[str, torch.Tensor]:
        """Feature dropout + panorama forward (twin of pano_apply): the
        view features are dropped at feat_dropout, then the encoder runs
        in training mode, both drawing from ``generator``."""
        view = pano_dev["view_img_fts"]
        if not deterministic and self.feat_dropout > 0:
            view = dropout(view, self.feat_dropout, generator)
        return forward_panorama(self.model["pano"], self.cfg.pano, view,
                                pano_dev["view_lens"],
                                loc_fts=pano_dev["loc_fts"],
                                nav_types=pano_dev["nav_types"],
                                generator=generator,
                                training=not deterministic)

    def panorama_dev_dict(self, pano_inputs, deterministic: bool,
                          seed: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """Panorama outputs left on the device, without a graph."""
        seed = self.next_seed() if seed is None else seed
        with torch.no_grad():
            return self.pano_apply(self._pano_dev_inputs(pano_inputs),
                                   self.generator(seed), deterministic)

    def replay_fuse_scan(self, pe_chunks: Sequence[torch.Tensor], live_rows,
                         t_pad: int, pm_grid, cur_ids, cand_ids, slot_ids,
                         fuse_sts, acts):
        """Scatter the fixed-width [chunk, V, H] pano chunks onto the
        [T*B] step grid (live_rows maps each chunk row to its grid row,
        padding rows to a trash row past the grid), then replay memory,
        fusion and history on the device (device_memory.replay_fuse).
        Returns (gmap_flat [T*B, G, H], hist_flat [T*B, Hh, H],
        final_state), all on the device."""
        t_pad, b = np.asarray(cur_ids).shape
        chunk, v, h = pe_chunks[0].shape
        grid = torch.zeros((t_pad * b + 1, v, h), dtype=pe_chunks[0].dtype,
                           device=self.device)
        for ci, pe in enumerate(pe_chunks):
            grid[self.upload(live_rows[ci * chunk: (ci + 1) * chunk])] = pe
        pe_grid = grid[:t_pad * b].reshape(t_pad, b, v, h)
        with torch.no_grad():
            gmap_seq, hist_seq, final = DM.replay_fuse(
                self.model, self.cfg, self.memory_init(b), pe_grid,
                self.upload(pm_grid), self.upload(cur_ids),
                self.upload(cand_ids), self.upload(slot_ids),
                {k: self.upload(x) for k, x in fuse_sts.items()},
                self.upload(acts))
        return (gmap_seq.reshape(t_pad * b, -1, h),
                hist_seq.reshape(t_pad * b, -1, h), final)

    def pano_navigation_train(self, pano_inputs, seed: int, batch, targets,
                              coef: float) -> torch.Tensor:
        """One navigation loss+grad call, one autograd graph: panorama
        with dropout (seeded by ``seed``) -> forward_navigation ->
        navigation_loss * coef -> backward into the params' .grad.
        batch holds host arrays and device tensors (gmap_img_embeds,
        hist_embeds); the stop row is prepended to the pano embeds here.
        Returns the loss as a device scalar: no host sync."""
        if not self.grads_open:
            raise RuntimeError("call zero_grads() before a training call")
        self.llm_token_units += 3.0 * float(
            np.asarray(batch["attention_mask"]).sum())
        self.grad_calls += 1
        pano_dev = self._pano_dev_inputs(pano_inputs)
        dev = {k: (v if torch.is_tensor(v) else self.upload(v))
               for k, v in batch.items()}
        with torch.enable_grad():
            pe = self.pano_apply(pano_dev, self.generator(seed),
                                 False)["pano_embeds"]
            stop = pe.new_zeros((pe.shape[0], 1, pe.shape[2]))
            dev["vp_img_embeds"] = torch.cat([stop, pe], dim=1)
            logits = NM.forward_navigation(self.model, self.cfg,
                                           dev)["fuse_logits"]
            loss = NM.navigation_loss(logits, self.upload(targets),
                                      self.ignore_id) * coef
            loss.backward()
        return loss.detach()

    def memory_init(self, batch: int, capacity: int = None):
        return DM.init_memory(batch, capacity or MEM_CAPACITY,
                              self.dims.max_hist, self.cfg.hidden_size,
                              torch.float32, self.device)

    def prefix_cache_init(self, batch: int, max_prefix: int,
                          kv_int8: bool = False):
        return DM.init_prefix_cache(self.cfg.llm, batch, max_prefix,
                                    kv_int8=kv_int8, device=self.device)

    def prefix_cache_enabled(self, batch: int, max_prefix: int,
                             n_caches: int = 1, kv_int8: bool = False) -> bool:
        """The JAX auto policy: cache the prompt prefix when the K/V caches
        (n_caches: one per slot group) fit next to the weights, counted
        from the actual leaves (so a quantized tree widens the budget;
        kv_int8 counts 1 + 4/head_dim bytes per element).

        The ceiling: JAX's 12e9 bytes was 0.75 of a 16 GB chip, leaving the
        rest for activations and the runtime. On the card it is 0.75 of the
        card's total memory (torch.cuda.get_device_properties), 60 GB on an
        80 GB H100: under 12e9 a bf16 7B tree (13.5 GB) would never cache
        there. On the CPU it stays 12e9, so CPU runs make JAX's decision."""
        c = self.cfg.llm
        itemsize = (1 + 4 / c.head_dim) if kv_int8 else c.dtype.itemsize
        bytes_needed = n_caches * int(2 * c.num_layers * batch * max_prefix
                                      * c.num_kv_heads * c.head_dim
                                      * itemsize)
        params_bytes = sum(p.numel() * p.element_size()
                           for p in self.model.parameters())
        ceiling = (0.75 * torch.cuda.get_device_properties(
            self.device).total_memory if self.device.type == "cuda"
            else 12e9)
        return self.device_memory and bytes_needed + params_bytes < ceiling

    def prefill(self, cache, ids, mask, rows, valid):
        """Prefill refilled rows' prefixes into ``cache`` (in place;
        device_memory.prefill_prefix). rows must be distinct: padding
        entries point at rows not being prefilled, with valid False.
        Counts the valid rows' prefix tokens in llm_token_units."""
        v = np.asarray(valid)
        self.llm_token_units += float((np.asarray(mask) * v[:, None]).sum())
        self.prefill_calls += 1
        with torch.inference_mode():
            return DM.prefill_prefix(
                self.model, self.cfg.llm, cache, self.upload(ids),
                self.upload(mask), self.upload(np.asarray(rows, np.int32)),
                self.upload(v))

    def eval_step_cached(self, state, cache, pano_inputs: Dict, batch: Dict,
                         reset_mask, cur_ids, cand_ids, active_mask,
                         a_t_override=None, do_sample: bool = False,
                         sync: bool = True):
        """Prefix-cached fused eval step (device_memory.eval_step_cached):
        eval_step's contract plus the cache, which is updated in place.
        Counts the active rows' window tokens in llm_token_units. Returns
        (state', cache, a_t, logits)."""
        if do_sample:
            raise NotImplementedError("sampled decoding is not ported")
        if a_t_override is None:
            a_t_override = np.full(len(cur_ids), -1, np.int32)
        pano = self._pano_dev_inputs(pano_inputs)
        dev = {k: self.upload(v) for k, v in batch.items()}
        act = np.asarray(active_mask)[:, None]
        self.llm_token_units += float(
            (np.asarray(batch["app_mask"]) * act).sum()
            + (np.asarray(batch["suf_mask"]) * act).sum())
        self.cached_steps += 1
        with torch.inference_mode():
            state, cache, a_t, logits = DM.eval_step_cached(
                self.model, self.cfg, state, cache, pano, dev,
                self.upload(reset_mask), self.upload(cur_ids),
                self.upload(cand_ids), self.upload(active_mask),
                self.upload(np.asarray(a_t_override, np.int32)))
        return state, cache, (HostCopy(a_t).result() if sync else a_t), logits

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
        pano = self._pano_dev_inputs(pano_inputs)
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
