"""NavModelRunner: the device entry points of evaluation and training.

Torch twin of the surface of navillm_tpu/agents/runner.py that streaming
evaluation and fused training (teacher and DAgger) use: ``cfg``,
``tok``, ``dims``, ``device_memory``, ``memory_init``, ``eval_step``,
``tokenize_with_positions``, the prefix cache (``prefix_cache_enabled``,
``prefix_cache_init``, ``prefill``, ``eval_step_cached``), the
``llm_token_units`` counter, ``panorama`` (its outputs on the host: the
3D-QA evaluation), for training ``zero_grads`` / ``take_grads``,
``panorama_dev_dict``, ``replay_fuse_scan`` and
``pano_navigation_train``, for the per-step rollout and the host-memory
path (``device_memory=False``) ``navigation``, ``generation``,
``panorama_device``, ``memory_update``, ``memory_reset_slots``,
``navigation_from_memory``, ``pano_mem_navigation_train``,
``history_append`` and ``fuse_embeds_only``, for generation the
special-token logit mask, ``gen_embeds``, ``generate`` (with an int8
prompt K/V when built with ``kv_int8``) and ``pano_generation_train`` (the
summarization / EQA / FGR2R heads and the ScanQA / LLaVA loss), for
object grounding (REVERIE, SOON) ``object_grounding`` and
``pano_og_train``, and for the fused DAgger's W8A8 sampling policy
(``--dagger_sample_quant``) ``sampling_quant_available``,
``sampling_params``, ``eval_step_q``, ``eval_step_cached_q`` and
``prefill_q``. Host arrays go up through pinned buffers with
non-blocking copies, so uploading one slot group's step never waits for
the other group's step running on the card. While a torch profiler
records, an eval step's or prefill's uploads are one ``upload`` span, its
device call alone a ``launch`` span, ``HostCopy``'s event wait a ``wait``
span, and every upload is counted (``utils/profiling.py``).

Randomness: jax.random keys become torch.Generators. The runner draws one
seed per dropout-bearing call from its own host generator; a call seeded
the same way (the fused trainer's phase-2 panorama and its phase-5
recompute) draws the same dropout masks. A sampled eval step (do_sample)
draws its actions on the device from a generator on the runner's device,
seeded the same way, as JAX draws them from a fresh key per call.

Under a mesh plan (``mesh_plan=``, parallel/mesh.py) the runner holds this
rank's shards of the LLM (sharded at build, after quantizing, as the JAX
runner shards its tree) and the model group travels with them
(``model.llm.tp``): the caches are sized by the local heads, ``take_grads``
averages the gradients over the data group (each rank's loss carries its
own batch's coefficient, so the average is the gradient of the data
group's concatenated batch), the token-mean losses count the data group's
valid tokens, and sampled actions are broadcast from the model group's
first rank. The W8A8 sampling policy is not available under a plan, as in
JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models import nav_model as NM
from ..models.decoding import generate
from ..models.nav_model import NavModel, NavModelConfig
from ..models.pano_encoder import dropout
from ..models.quant import is_quantized, quantize_nav_params
from ..models.tokenization import NavTokenizer
from ..parallel.mesh import flat_specs, nav_param_specs, shard_params
from ..utils.profiling import count, span
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
    # objects per viewpoint (<cand> tokens of the object-grounding prompt)
    max_objects: int = 72
    # prompt-prefix KV cache capacity per slot (instruction + history
    # tokens; the cached streaming eval raises if a prefix outgrows it)
    max_prefix: int = 768

    @classmethod
    def tiny(cls) -> "RolloutDims":
        return cls(max_gmap_nodes=16, max_views=40, max_cands=8, max_hist=8,
                   max_objects=8, max_prefix=448)


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
            with span("wait", "runner"):
                self.event.synchronize()
        return self.buf.numpy()


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, float ones in f32 (numpy has no
    bf16)."""
    t = t.detach()
    return HostCopy(t.float() if t.is_floating_point() else t).result()


class NavModelRunner:
    PANO_KEYS = ("view_img_fts", "view_lens", "loc_fts", "nav_types",
                 "obj_img_fts", "obj_lens", "obj_loc_fts")

    def __init__(self, cfg: NavModelConfig, model: NavModel,
                 tokenizer: NavTokenizer, dims: RolloutDims = RolloutDims(),
                 device: Optional[torch.device] = None,
                 feat_dropout: float = 0.4, ignore_id: int = -100,
                 seed: int = 0, device_memory: bool = True,
                 kv_int8: bool = False, mesh_plan=None):
        if cfg.llm.act_int8 and not is_quantized(model):
            raise ValueError("act_int8 needs a quantized LLM: int8 "
                             "activations only run against quantized "
                             "weights (models/llama.py:_mm)")
        self.cfg = cfg
        self.plan = mesh_plan
        # {parameter name: partition spec} of the (sharded) tree
        self.param_specs = {}
        if mesh_plan is not None:
            model = self._shard(model, mesh_plan)
        self.model = model
        self.tok = tokenizer
        self.dims = dims
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        # graph memory and history on the device (the fused eval and
        # training steps), or on the host (graph maps hold the node
        # embeddings, each step uploads them: runner.navigation)
        self.device_memory = device_memory
        # int8 prompt K/V in generate (the streaming prefix cache takes its
        # own kv_int8 through prefix_cache_init)
        self.kv_int8 = kv_int8
        self.feat_dropout = feat_dropout
        self.ignore_id = ignore_id
        self.rng = torch.Generator().manual_seed(seed)
        # the LM's logit mask: the tokenizer's specials, and every column of
        # an embedding wider than the tokenizer (a 7B table keeps its 32k
        # width over the ~1k ids of the hermetic tokenizers)
        smask = np.asarray(tokenizer.special_logit_mask())
        v = cfg.llm.vocab_size
        if smask.shape[0] < v:
            smask = np.concatenate([smask, np.ones(v - smask.shape[0], bool)])
        self.special_mask = torch.from_numpy(smask[:v]).to(self.device)
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
        # loss+grad calls, navigation and generation heads alike (each runs
        # every LLM layer forward, recomputed forward under remat, and
        # backward), and of those the generation heads' calls
        self.grad_calls = 0
        self.gen_grad_calls = 0
        # generate calls (each one prefill over every layer, then the
        # decode steps)
        self.generate_calls = 0
        # object-grounding forwards without a gradient (each runs every LLM
        # layer once), and of the grad calls those of the OG head
        self.og_calls = 0
        self.og_grad_calls = 0
        # the other LLM forwards without a gradient (each runs every LLM
        # layer once over the prompt): navigation and navigation_from_memory
        # (the host-memory and batched evaluation steps) and generation's
        # loss without training
        self.forward_calls = 0
        # the W8A8 sampling policy: its config, the int8 copy of the LLM
        # and the key of the weights it was made from; re-quantizations and
        # the seconds they took
        self.cfg_q = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, act_int8=True))
        self._samp_q = None
        self._samp_key = None
        self.sampling_quantizations = 0
        self.sampling_quant_s = 0.0

    def _shard(self, model: NavModel, plan) -> NavModel:
        """This rank's shards of a whole tree (mesh.shard_params under
        nav_param_specs), as a NavModel whose LLM carries the model
        group."""
        from ..models.quant import weight_bits
        quantized = is_quantized(model)
        specs = nav_param_specs(self.cfg, quantized=quantized,
                                bits=weight_bits(model) if quantized else 8)
        self.param_specs = flat_specs(specs)
        with torch.no_grad():
            local = NavModel(self.cfg, shard_params(model, specs, plan))
        local.llm.tp = plan.model_group
        return local

    def upload(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Host array -> device tensor without a stream sync (pinned,
        non-blocking on CUDA); ``dtype`` casts on the host first. Counted
        in the trace's ``uploads`` and ``h2d_bytes`` while a profiler
        records."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        count(uploads=1, h2d_bytes=t.nbytes)
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
        names (the .grad tensors themselves, not copies), averaged over
        the data group under a plan."""
        self.grads_open = False
        grads = {n: p.grad for n, p in self.model.named_parameters()}
        if self.plan is not None and self.plan.dp_size > 1:
            inv = 1.0 / self.plan.dp_size
            with torch.no_grad():
                for g in grads.values():
                    g.copy_(self.plan.data.all_reduce(g)).mul_(inv)
        return grads

    def _count_group(self):
        """The data group of the token-mean losses (None: this batch)."""
        if self.plan is not None and self.plan.dp_size > 1:
            return self.plan.data
        return None

    def _pano_dev_inputs(self, pano_inputs) -> Dict[str, torch.Tensor]:
        return {k: (v if torch.is_tensor(v) else self.upload(v))
                for k, v in pano_inputs.items() if k in self.PANO_KEYS}

    def pano_apply(self, pano_dev, generator: Optional[torch.Generator],
                   deterministic: bool) -> Dict[str, torch.Tensor]:
        """Feature dropout + panorama forward (twin of pano_apply): the
        view features, then the object features when there are any, are
        dropped at feat_dropout, then the encoder runs in training mode,
        all drawing from ``generator``."""
        pano_dev = dict(pano_dev)
        if not deterministic and self.feat_dropout > 0:
            for k in ("view_img_fts", "obj_img_fts"):
                if k in pano_dev:
                    pano_dev[k] = dropout(pano_dev[k], self.feat_dropout,
                                          generator)
        return DM.panorama(self.model, self.cfg, pano_dev, generator,
                           training=not deterministic)

    def panorama(self, pano_inputs, deterministic: bool,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """panorama_dev_dict, downloaded: every output on the host, float
        outputs in f32 (numpy has no bf16)."""
        out = self.panorama_dev_dict(pano_inputs, deterministic, seed)
        return {k: _host(v) for k, v in out.items()}

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

    def _dev_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A batch of host arrays and device tensors, all on the device."""
        return {k: (v if torch.is_tensor(v) else self.upload(v))
                for k, v in batch.items()}

    def pano_navigation_train(self, pano_inputs, seed: int, batch, targets,
                              coef: float, need_outputs: bool = False):
        """One navigation loss+grad call, one autograd graph: panorama
        with dropout (seeded by ``seed``) -> forward_navigation ->
        navigation_loss * coef -> backward into the params' .grad.
        batch holds host arrays and device tensors (gmap_img_embeds,
        hist_embeds); the stop row is prepended to the pano embeds here.
        Returns the loss as a device scalar: no host sync. With
        need_outputs (the per-step host-memory rollout) JAX's tuple
        instead: (logits [B, G], fuse_embeds [B, G, H], pano_embeds,
        pano_masks, all on the host in f32, and the loss as a float)."""
        if not self.grads_open:
            raise RuntimeError("call zero_grads() before a training call")
        self.llm_token_units += 3.0 * float(
            np.asarray(batch["attention_mask"]).sum())
        self.grad_calls += 1
        pano_dev = self._pano_dev_inputs(pano_inputs)
        dev = self._dev_batch(batch)
        with torch.enable_grad():
            po = self.pano_apply(pano_dev, self.generator(seed), False)
            pe = po["pano_embeds"]
            stop = pe.new_zeros((pe.shape[0], 1, pe.shape[2]))
            dev["vp_img_embeds"] = torch.cat([stop, pe], dim=1)
            out = NM.forward_navigation(self.model, self.cfg, dev)
            loss = NM.navigation_loss(out["fuse_logits"],
                                      self.upload(targets),
                                      self.ignore_id) * coef
            loss.backward()
        if not need_outputs:
            return loss.detach()
        return (_host(out["fuse_logits"]), _host(out["fuse_embeds"]),
                _host(pe), _host(po["pano_masks"]), float(loss.detach()))

    def pano_generation_train(self, pano_inputs, seed: int, batch,
                              coef: float) -> torch.Tensor:
        """One generation-loss grad call (summarization / EQA / FGR2R
        heads), one autograd graph: panorama with dropout (seeded by
        ``seed``) -> forward_generation_loss * coef -> backward into the
        params' .grad, the panorama encoder's included. batch holds host
        arrays (input_ids, attention_mask, labels, vp_masks, positions,
        hist_embeds). Returns the loss as a device scalar: no host sync."""
        if not self.grads_open:
            raise RuntimeError("call zero_grads() before a training call")
        self.llm_token_units += 3.0 * float(
            np.asarray(batch["attention_mask"]).sum())
        self.grad_calls += 1
        self.gen_grad_calls += 1
        pano_dev = self._pano_dev_inputs(pano_inputs)
        dev = {k: (v if torch.is_tensor(v) else self.upload(v))
               for k, v in batch.items()}
        dev["special_token_mask"] = self.special_mask
        with torch.enable_grad():
            dev["vp_img_embeds"] = self.pano_apply(
                pano_dev, self.generator(seed), False)["pano_embeds"]
            loss = NM.forward_generation_loss(
                self.model, self.cfg, dev,
                self._count_group())["loss"] * coef
            loss.backward()
        return loss.detach()

    def pano_og_train(self, pano_inputs, seed: int, batch, targets,
                      coef: float, need_logits: bool = True):
        """One object-grounding grad call, one autograd graph: panorama with
        dropout (seeded by ``seed``) -> obj_embeds -> forward_object_grounding
        -> navigation_loss * coef -> backward into the params' .grad, the
        object branch of the panorama encoder included (JAX: the grad to the
        params and to obj_embeds, then the panorama's object VJP). batch
        holds host arrays (the prompt, obj_loc_fts, obj_masks, positions,
        hist_embeds). Returns (obj_logits [B, 100] on the host, or None
        without need_logits, which spares the sync; the loss as a device
        scalar)."""
        if not self.grads_open:
            raise RuntimeError("call zero_grads() before a training call")
        self.llm_token_units += 3.0 * float(
            np.asarray(batch["attention_mask"]).sum())
        self.grad_calls += 1
        self.og_grad_calls += 1
        pano_dev = self._pano_dev_inputs(pano_inputs)
        dev = {k: (v if torch.is_tensor(v) else self.upload(v))
               for k, v in batch.items()}
        with torch.enable_grad():
            dev["obj_embeds"] = self.pano_apply(
                pano_dev, self.generator(seed), False)["obj_embeds"]
            logits = NM.forward_object_grounding(self.model, self.cfg,
                                                 dev)["obj_logits"]
            loss = NM.navigation_loss(logits, self.upload(targets),
                                      self.ignore_id) * coef
            loss.backward()
        if not need_logits:
            return None, loss.detach()
        return HostCopy(logits.detach()).result(), loss.detach()

    def object_grounding(self, batch, targets=None, coef: float = 1.0,
                         train: bool = False):
        """forward_object_grounding on a batch with obj_embeds given (host
        array or device tensor). Inference: (obj_logits [B, 100] on the
        host, 0.0). train: the loss * coef backpropagates into the params'
        .grad (not into the panorama: see pano_og_train), and the loss comes
        back as a float."""
        dev = {k: (v if torch.is_tensor(v) else self.upload(v))
               for k, v in batch.items()}
        if train:
            if not self.grads_open:
                raise RuntimeError("call zero_grads() before a training "
                                   "call")
            self.llm_token_units += 3.0 * float(
                np.asarray(batch["attention_mask"]).sum())
            self.grad_calls += 1
            self.og_grad_calls += 1
            with torch.enable_grad():
                logits = NM.forward_object_grounding(self.model, self.cfg,
                                                     dev)["obj_logits"]
                loss = NM.navigation_loss(logits, self.upload(targets),
                                          self.ignore_id) * coef
                loss.backward()
            return HostCopy(logits.detach()).result(), float(loss)
        self.llm_token_units += float(np.asarray(batch["attention_mask"]).sum())
        self.og_calls += 1
        with torch.inference_mode():
            logits = NM.forward_object_grounding(self.model, self.cfg,
                                                 dev)["obj_logits"]
        return HostCopy(logits).result(), 0.0

    def gen_embeds(self, vp_img_embeds, vp_masks) -> torch.Tensor:
        """The zero-position, type-0 fusion of the generation paths, on the
        device; host embeds go up in the panorama's dtype."""
        if not torch.is_tensor(vp_img_embeds):
            vp_img_embeds = self.upload(vp_img_embeds, self.cfg.pano.dtype)
        with torch.inference_mode():
            return NM.prep_generation_embeds(self.model, self.cfg,
                                             vp_img_embeds,
                                             self.upload(vp_masks))

    def generate(self, input_ids, attention_mask, inject_positions,
                 inject_embeds, max_new_tokens: int, do_sample: bool = False,
                 temperature: float = 1.0, trie=None) -> np.ndarray:
        """models/decoding.generate on the LLM under the special-token
        mask; with do_sample the draws come from a generator on the
        runner's device, seeded from next_seed(). Returns the token ids
        [B, max_new_tokens] on the host."""
        self.generate_calls += 1
        gen = self.generator(self.next_seed()) if do_sample else None
        out = generate(self.model["llm"], self.cfg.llm, input_ids,
                       attention_mask, inject_positions=inject_positions,
                       inject_embeds=inject_embeds,
                       special_token_mask=self.special_mask,
                       eos_id=self.tok.eos_id, pad_id=self.tok.pad_id,
                       max_new_tokens=max_new_tokens, do_sample=do_sample,
                       temperature=temperature, generator=gen, trie=trie,
                       kv_int8=self.kv_int8)
        return HostCopy(out).result()

    def memory_init(self, batch: int, capacity: int = None):
        return DM.init_memory(batch, capacity or MEM_CAPACITY,
                              self.dims.max_hist, self.cfg.hidden_size,
                              torch.float32, self.device)

    def prefix_cache_init(self, batch: int, max_prefix: int,
                          kv_int8: bool = False):
        return DM.init_prefix_cache(self.cfg.llm, batch, max_prefix,
                                    kv_int8=kv_int8, device=self.device,
                                    num_kv_heads=self._local_kv_heads())

    def _local_kv_heads(self) -> int:
        from ..models.llama import local_heads
        return local_heads(self.model["llm"], self.cfg.llm)[1]

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
        bytes_needed = n_caches * self.prefix_cache_bytes(batch, max_prefix,
                                                          kv_int8)
        return self.device_memory and \
            bytes_needed + self.params_bytes() < self.memory_ceiling()

    def prefix_cache_bytes(self, batch: int, max_prefix: int,
                           kv_int8: bool = False) -> int:
        """Bytes of one [L, batch, max_prefix, NKV, D] K and V cache (this
        rank's heads)."""
        c = self.cfg.llm
        itemsize = (1 + 4 / c.head_dim) if kv_int8 else c.dtype.itemsize
        return int(2 * c.num_layers * batch * max_prefix
                   * self._local_kv_heads() * c.head_dim * itemsize)

    def params_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.model.parameters())

    def memory_ceiling(self) -> float:
        """The memory policies' ceiling: 0.75 of the card's memory, 12e9
        bytes on the CPU (see prefix_cache_enabled)."""
        if self.device.type == "cuda":
            return 0.75 * torch.cuda.get_device_properties(
                self.device).total_memory
        return 12e9

    # ------------------------------------------ W8A8 sampling policy --- #
    def sampling_quant_available(self) -> bool:
        """The W8A8 policy quantizes the live dense LLM; a tree that is
        quantized already (evaluation) has none to quantize, and a plan's
        shards none to hand it (as in JAX)."""
        return self.plan is None and not is_quantized(self.model)

    def _llm_versions(self) -> int:
        """The sum of the LLM leaves' version counters: every in-place
        write (an optimizer step's p.add_, a checkpoint's copy_) bumps
        it."""
        return sum(p._version for p in self.model["llm"].parameters())

    def sampling_params(self) -> NavModel:
        """The policy of the fused DAgger's sampling with
        --dagger_sample_quant: the live tree with its LLM quantized to int8
        (quantize_nav_params(bits=8), one layer at a time; the panorama
        encoder and the heads are the live ones), run with act_int8
        (``cfg_q``). The optimizers update the parameters in place, so the
        copy is keyed to the LLM leaves' version counters, which every
        optimizer step bumps, and made anew (the old copy freed first)
        when they moved: the policy samples from the current weights up to
        the int8 grid, as JAX's, which re-quantizes each new tree."""
        key = (id(self.model), self._llm_versions())
        if self._samp_key != key:
            self._samp_q = None
            t0 = time.perf_counter()
            with torch.no_grad():
                self._samp_q = NavModel(self.cfg_q,
                                        quantize_nav_params(self.model, 8))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.sampling_quant_s += time.perf_counter() - t0
            self.sampling_quantizations += 1
            self._samp_key = key
        return self._samp_q

    def _policy(self, quant: bool):
        """(params, cfg) of the live policy or of the W8A8 one."""
        return (self.sampling_params(), self.cfg_q) if quant \
            else (self.model, self.cfg)

    def prefill_q(self, cache, ids, mask, rows, valid):
        """prefill against the W8A8 sampling policy, so the cached K/V
        comes from the policy that steps on it."""
        return self.prefill(cache, ids, mask, rows, valid, quant=True)

    def eval_step_q(self, *args, **kwargs):
        """eval_step against the W8A8 sampling policy."""
        return self.eval_step(*args, quant=True, **kwargs)

    def eval_step_cached_q(self, *args, **kwargs):
        """eval_step_cached against the W8A8 sampling policy."""
        return self.eval_step_cached(*args, quant=True, **kwargs)

    def prefill(self, cache, ids, mask, rows, valid, quant: bool = False):
        """Prefill refilled rows' prefixes into ``cache`` (in place;
        device_memory.prefill_prefix). rows must be distinct: padding
        entries point at rows not being prefilled, with valid False.
        Counts the valid rows' prefix tokens in llm_token_units. quant:
        through the W8A8 sampling policy (prefill_q)."""
        v = np.asarray(valid)
        self.llm_token_units += float((np.asarray(mask) * v[:, None]).sum())
        self.prefill_calls += 1
        params, cfg = self._policy(quant)
        with span("upload", "runner"):
            up = (self.upload(ids), self.upload(mask),
                  self.upload(np.asarray(rows, np.int32)), self.upload(v))
        with span("launch", "runner"), torch.inference_mode():
            return DM.prefill_prefix(params, cfg.llm, cache, *up)

    def _step_uploads(self, pano_inputs, batch, reset_mask, cur_ids,
                      cand_ids, active_mask, a_t_override):
        """The device arguments of an eval step, uploaded in one span:
        (panorama inputs, batch, (reset, cur_ids, cand_ids, active,
        a_t_override))."""
        if a_t_override is None:
            a_t_override = np.full(len(cur_ids), -1, np.int32)
        with span("upload", "runner"):
            pano = self._pano_dev_inputs(pano_inputs)
            dev = {k: self.upload(v) for k, v in batch.items()}
            ids = tuple(self.upload(x) for x in (
                reset_mask, cur_ids, cand_ids, active_mask,
                np.asarray(a_t_override, np.int32)))
        return pano, dev, ids

    def _sampling(self, do_sample: bool, temperature: float):
        """device_memory's action-selection arguments: with do_sample a
        generator on the runner's device, seeded from next_seed()."""
        gen = self.generator(self.next_seed()) if do_sample else None
        return {"do_sample": do_sample, "temperature": float(temperature),
                "generator": gen}

    def eval_step_cached(self, state, cache, pano_inputs: Dict, batch: Dict,
                         reset_mask, cur_ids, cand_ids, active_mask,
                         a_t_override=None, do_sample: bool = False,
                         temperature: float = 1.0, sync: bool = True,
                         quant: bool = False):
        """Prefix-cached fused eval step (device_memory.eval_step_cached):
        eval_step's contract plus the cache, which is updated in place.
        Counts the active rows' window tokens in llm_token_units. Returns
        (state', cache, a_t, logits). quant: through the W8A8 sampling
        policy (eval_step_cached_q)."""
        pano, dev, ids = self._step_uploads(pano_inputs, batch, reset_mask,
                                            cur_ids, cand_ids, active_mask,
                                            a_t_override)
        act = np.asarray(active_mask)[:, None]
        self.llm_token_units += float(
            (np.asarray(batch["app_mask"]) * act).sum()
            + (np.asarray(batch["suf_mask"]) * act).sum())
        self.cached_steps += 1
        count(steps=1)
        params, cfg = self._policy(quant)
        sampling = self._sampling(do_sample, temperature)
        with span("launch", "runner"), torch.inference_mode():
            state, cache, a_t, logits = DM.eval_step_cached(
                params, cfg, state, cache, pano, dev, *ids, **sampling)
        return state, cache, (HostCopy(a_t).result() if sync else a_t), logits

    def eval_step(self, state, pano_inputs: Dict, batch: Dict, reset_mask,
                  cur_ids, cand_ids, active_mask, a_t_override=None,
                  do_sample: bool = False, temperature: float = 1.0,
                  sync: bool = True, quant: bool = False):
        """ONE device call per streaming-eval step (reset -> pano -> memory
        update -> nav forward -> argmax, or with do_sample a draw at
        ``temperature`` on the device -> hist append). pano_inputs'
        view_img_fts may already be a device tensor. Returns (new_state,
        a_t, logits [B, G] on device); a_t is a numpy array, or with
        sync=False the device tensor, so the caller can overlap host work
        with the step and download a_t later (HostCopy). quant: through
        the W8A8 sampling policy (eval_step_q)."""
        pano, dev, ids = self._step_uploads(pano_inputs, batch, reset_mask,
                                            cur_ids, cand_ids, active_mask,
                                            a_t_override)
        self.llm_token_units += float(np.asarray(batch["attention_mask"]).sum())
        self.eval_steps += 1
        count(steps=1)
        params, cfg = self._policy(quant)
        sampling = self._sampling(do_sample, temperature)
        with span("launch", "runner"), torch.inference_mode():
            state, a_t, logits = DM.eval_step(
                params, cfg, state, pano, dev, *ids, **sampling)
        return state, (HostCopy(a_t).result() if sync else a_t), logits

    # ------------------- the per-step and host-memory paths ------------ #
    def _tokens(self, batch) -> float:
        return float(np.asarray(batch["attention_mask"]).sum())

    def navigation(self, batch, targets=None, coef: float = 1.0,
                   train: bool = False):
        """forward_navigation on a batch that carries its embeddings
        (gmap_img_embeds, vp_img_embeds, hist_embeds: the host-memory step
        and the batched evaluation). train: navigation_loss * coef
        backpropagates into the params' .grad. Returns (fuse_logits [B, G],
        fuse_embeds [B, G, H], both on the host in f32, and the loss as a
        float, 0.0 without train)."""
        dev = self._dev_batch(batch)
        if train:
            if not self.grads_open:
                raise RuntimeError("call zero_grads() before a training "
                                   "call")
            self.llm_token_units += 3.0 * self._tokens(batch)
            self.grad_calls += 1
            with torch.enable_grad():
                out = NM.forward_navigation(self.model, self.cfg, dev)
                loss = NM.navigation_loss(out["fuse_logits"],
                                          self.upload(targets),
                                          self.ignore_id) * coef
                loss.backward()
            return (_host(out["fuse_logits"]), _host(out["fuse_embeds"]),
                    float(loss.detach()))
        self.llm_token_units += self._tokens(batch)
        self.forward_calls += 1
        with torch.inference_mode():
            out = NM.forward_navigation(self.model, self.cfg, dev)
        return _host(out["fuse_logits"]), _host(out["fuse_embeds"]), 0.0

    def generation(self, batch, coef: float = 1.0,
                   train: bool = False) -> float:
        """forward_generation_loss on a batch that carries vp_img_embeds
        (no panorama in the graph: see pano_generation_train). train: the
        loss * coef backpropagates into the params' .grad. Returns the loss
        as a float."""
        dev = self._dev_batch(batch)
        dev["special_token_mask"] = self.special_mask
        if not train:
            self.llm_token_units += self._tokens(batch)
            self.forward_calls += 1
            with torch.inference_mode():
                return float(NM.forward_generation_loss(
                    self.model, self.cfg, dev)["loss"])
        if not self.grads_open:
            raise RuntimeError("call zero_grads() before a training call")
        self.llm_token_units += 3.0 * self._tokens(batch)
        self.grad_calls += 1
        self.gen_grad_calls += 1
        with torch.enable_grad():
            loss = NM.forward_generation_loss(
                self.model, self.cfg, dev,
                self._count_group())["loss"] * coef
            loss.backward()
        return float(loss.detach())

    def panorama_device(self, pano_inputs, deterministic: bool):
        """The panorama encoder's (pano_embeds, pano_masks), left on the
        device without a graph; dropout (not deterministic) from a fresh
        seed."""
        out = self.panorama_dev_dict(pano_inputs, deterministic)
        return out["pano_embeds"], out["pano_masks"]

    def memory_update(self, state, pano_embeds, pano_masks, cur_ids,
                      cand_ids):
        with torch.no_grad():
            return DM.memory_update(state, pano_embeds, pano_masks,
                                    self.upload(cur_ids),
                                    self.upload(cand_ids))

    def memory_reset_slots(self, state, reset_mask):
        return DM.reset_slots(state, self.upload(reset_mask))

    def navigation_from_memory(self, state, batch, pano_embeds):
        """A navigation forward whose gmap, vp and history embeddings come
        from the device memory (device_memory.nav_step_from_memory).
        Returns (fuse_logits [B, G] on the host, fuse_embeds on the
        device)."""
        self.llm_token_units += self._tokens(batch)
        self.forward_calls += 1
        with torch.inference_mode():
            logits, fuse = DM.nav_step_from_memory(
                self.model, self.cfg, state, self._dev_batch(batch),
                pano_embeds)
        return _host(logits), fuse

    def pano_mem_navigation_train(self, state, seed: int, pano_inputs, batch,
                                  targets, coef: float, sync: bool = True):
        """The per-step training step on the device memory, one autograd
        graph: panorama with dropout (seeded by ``seed``) -> memory update
        from the detached embeddings -> gmap / vp / history assembly ->
        forward_navigation -> navigation_loss * coef -> backward into the
        params' .grad (the panorama encoder's through the vp embeddings).
        batch holds the fusion and prompt arrays plus cur_ids, cand_ids
        and slot_ids. Returns (new_state, logits [B, G], fuse_embeds on the
        device, loss). Memory and history leave the graph: nothing of one
        step is differentiated through the next. With sync (the default)
        logits come to the host and the loss is a float; sync=False keeps
        both on the device, so the caller can run other host work before
        it waits (rollout_interleaved)."""
        if not self.grads_open:
            raise RuntimeError("call zero_grads() before a training call")
        self.llm_token_units += 3.0 * self._tokens(batch)
        self.grad_calls += 1
        pano_dev = self._pano_dev_inputs(pano_inputs)
        dev = self._dev_batch(batch)
        ids = {k: dev.pop(k) for k in ("cur_ids", "cand_ids", "slot_ids")}
        with torch.enable_grad():
            po = self.pano_apply(pano_dev, self.generator(seed), False)
            pe, pm = po["pano_embeds"], po["pano_masks"]
            state = DM.memory_update(state, pe.detach(), pm, ids["cur_ids"],
                                     ids["cand_ids"])
            dev["gmap_img_embeds"], dev["vp_img_embeds"] = \
                DM.assemble_from_memory(state, ids["slot_ids"], pe)
            dev["hist_embeds"] = state["hist_buf"]
            out = NM.forward_navigation(self.model, self.cfg, dev)
            loss = NM.navigation_loss(out["fuse_logits"],
                                      self.upload(targets),
                                      self.ignore_id) * coef
            loss.backward()
        logits, fuse = out["fuse_logits"].detach(), \
            out["fuse_embeds"].detach()
        if not sync:
            return state, logits, fuse, loss.detach()
        return state, _host(logits), fuse, float(loss.detach())

    def history_append(self, state, fuse_embeds, a_t):
        """Append fuse_embeds[b, a_t[b]] to each row's history (a_t < 0:
        none)."""
        return DM.hist_append(state, fuse_embeds.detach(),
                              self.upload(np.asarray(a_t, np.int64)))

    def fuse_embeds_only(self, batch) -> np.ndarray:
        """Graph/local fusion without the LLM (the history embeddings of
        the fused trainer's host-memory path). Returns [B, G, H] f32 on the
        host."""
        with torch.inference_mode():
            fuse, _ = NM.fuse_gmap_local(self.model, self.cfg,
                                         self._dev_batch(batch))
        return _host(fuse)

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
