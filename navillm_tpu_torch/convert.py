"""Parameter trees for the port: converted from JAX, or drawn at random.

- ``params_from_jax`` takes the JAX navigation parameter tree as nested
  dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), keyed as
  navillm_tpu's ``init_nav_params`` / ``init_pano_params`` /
  ``llama.weight_spec`` build it, and returns the same tree as torch
  tensors, so both packages compute the same function.
- Both builders put their tensors on the card unless the caller names
  another device (``device="cpu"``, as the CPU tests do); with no CUDA
  device and none named they raise, rather than build a model that would
  run the eager CPU path with no kernel.
- ``vit_params_from_jax`` does the same for the ViT of the feature
  extraction (vision/vit.py keeps the JAX tree's layout).
- ``flatten_tree`` / ``grads_to_numpy`` name every leaf of a nested tree,
  and every gradient of a model, by its dotted JAX path (``llm.layers.wq``),
  so gradient trees compare leaf by leaf.
- ``init_nav_params`` draws a fresh tree with the JAX init's shapes and
  scales straight on the target device in the config's dtypes (the 7B
  tree in bf16 on the card, never staged in f32 on the host); with
  ``quantize_llm`` the LLM is drawn already quantized, one weight at a time
  (models/quant.py:init_params_quantized). Torch's generator gives other
  numbers than jax.random: parity tests convert the JAX tree instead.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .models import llama as L
from .models.nav_model import MAX_ACTION_STEPS, NUM_CAND_SLOTS, NavModelConfig
from .models.pano_encoder import PanoConfig


def target_device(device=None) -> torch.device:
    """``device``, or the card when it is None; raises when it is None and
    there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's models are built on "
                           "the card; pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)            # a writable copy (JAX hands out read-only)
    if a.dtype.name == "bfloat16":     # ml_dtypes arrays from a bf16 tree
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX tree as torch tensors on ``device`` (default: the card)."""
    device = target_device(device)
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else _tensor(v, device)) for k, v in tree.items()}


def vit_params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A JAX ViT tree (navillm_tpu/vision/vit.py: patch_embed, pos_embed,
    cls_token, ln_pre for clip, ln_post, and the stacked ``layers``) in the
    port's layout, which keeps the JAX names, shapes and dtypes, on
    ``device`` (default: the card)."""
    missing = {"patch_embed", "pos_embed", "ln_post", "layers"} - set(tree)
    if missing:
        raise KeyError(f"not a ViT parameter tree: no {sorted(missing)}")
    return params_from_jax(tree, device)


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts or ParamTrees -> {"a.b.c": leaf}, the names ParamTree's
    named_parameters() gives the same leaves."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def grads_to_numpy(model) -> Dict[str, np.ndarray]:
    """{dotted name: gradient as f32 numpy} for every parameter of a
    ParamTree (zeros where a parameter has no gradient)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().float().cpu().numpy()
            for n, p in model.named_parameters()}


class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.g, device=self.device,
                           dtype=self.dtype).mul_(scale)

    def dense(self, shape, scale=None):
        return self.normal(shape, scale if scale is not None
                           else shape[-2] ** -0.5)

    def const(self, shape, value):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def linear(self, d_in, d_out):
        return {"w": self.dense((d_in, d_out)),
                "b": self.const((d_out,), 0.0)}

    def ln(self, d):
        return {"s": self.const((d,), 1.0), "b": self.const((d,), 0.0)}


def init_llama_params(cfg: L.LlamaConfig, generator, device=None):
    init = _Init(generator, target_device(device), cfg.dtype)
    spec = L.weight_spec(cfg)
    layers = {k: init.dense(*v) for k, v in spec["layers"].items()}
    layers["attn_norm"] = init.const((cfg.num_layers, cfg.hidden_size), 1.0)
    layers["mlp_norm"] = init.const((cfg.num_layers, cfg.hidden_size), 1.0)
    return {"embed": init.dense(*spec["embed"]), "layers": layers,
            "final_norm": init.const((cfg.hidden_size,), 1.0),
            "lm_head": init.dense(*spec["lm_head"])}


def init_pano_params(cfg: PanoConfig, generator, device=None):
    init = _Init(generator, target_device(device), cfg.dtype)
    h, i, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_pano_layers
    p = {"img_linear": init.linear(cfg.image_feat_size, h),
         "img_ln": init.ln(h),
         "loc_linear": init.linear(cfg.loc_size, h),
         "loc_ln": init.ln(h),
         "nav_type_emb": init.normal((3, h), 0.02),
         "ln": init.ln(h),
         "mapper": init.linear(h, cfg.output_size)}
    if n > 0:
        def stack(make):
            layers = [make() for _ in range(n)]
            return {k: torch.stack([lay[k] for lay in layers])
                    for k in layers[0]}
        p["encoder"] = {"ln1": stack(lambda: init.ln(h)),
                        "qkv": stack(lambda: init.linear(h, 3 * h)),
                        "out": stack(lambda: init.linear(h, h)),
                        "ln2": stack(lambda: init.ln(h)),
                        "ffn1": stack(lambda: init.linear(h, i)),
                        "ffn2": stack(lambda: init.linear(i, h))}
        p["encoder_norm"] = init.ln(h)
    if cfg.use_obj:
        p["obj_projector"] = init.linear(cfg.obj_feat_size, cfg.output_size)
        p["obj_projector_ln"] = init.ln(cfg.output_size)
        if cfg.fuse_obj:
            p["obj_linear"] = init.linear(cfg.obj_feat_size, h)
            p["obj_linear_ln"] = init.ln(h)
    return p


def init_nav_params(cfg: NavModelConfig, generator: torch.Generator,
                    device: Optional[torch.device] = None,
                    llm: Optional[Dict[str, Any]] = None,
                    quantize_llm: bool = False,
                    quant_bits: int = 8) -> Dict[str, Any]:
    """Random navigation parameters on ``device`` (default: the card; the
    generator must live on the same device). ``llm``, a loaded LLM tree,
    takes the LLM's place and none is drawn. quantize_llm draws the LLM
    quantized (layer matmuls at ``quant_bits``, embed and lm_head int8),
    from the same generator stream, without the dense tree ever existing
    whole (JAX init_nav_params(quantize_llm=True))."""
    from .models.quant import init_params_quantized

    device = target_device(device)
    h, a = cfg.hidden_size, cfg.angle_feat_size
    init = _Init(generator, device, cfg.llm.dtype)

    def mlp_ln(d_in):
        return {**init.linear(d_in, h), "ln_s": init.const((h,), 1.0),
                "ln_b": init.const((h,), 0.0)}

    return {
        "llm": llm if llm is not None
        else init_params_quantized(cfg.llm, generator, quant_bits, device)
        if quantize_llm else init_llama_params(cfg.llm, generator, device),
        "pano": init_pano_params(cfg.pano, generator, device),
        "token_type_emb": init.normal((cfg.type_vocab_size, h), 0.02),
        "gmap_pos": mlp_ln(a + 3),
        "gmap_step_emb": init.normal((MAX_ACTION_STEPS, h), 0.02),
        "vp_pos": mlp_ln(2 * a + 6),
        "obj_pos": mlp_ln(a + 3),
        "out_head": {"w": init.dense((h, NUM_CAND_SLOTS)),
                     "b": init.const((NUM_CAND_SLOTS,), 0.0)},
    }
