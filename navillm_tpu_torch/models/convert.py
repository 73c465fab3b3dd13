"""HF-layout Llama checkpoint -> the port's LLM parameter tree.

Torch twin of navillm_tpu/models/convert.py, without ``transformers`` or
``safetensors`` (the card's machine has neither):

- ``read_hf_config`` / ``config_from_hf``: ``config.json`` as plain JSON,
  with the fields and defaults of HF's LlamaConfig;
- ``SafetensorsFile``: a reader of the safetensors layout (an 8-byte
  little-endian header length, a JSON header, then the raw tensors at the
  header's ``data_offsets``, counted from the end of the header); each
  tensor is a ``torch.frombuffer`` view over an ``mmap`` of the file;
- ``load_vicuna_streaming``: restacks the per-layer weights into the
  port's layout (``models/llama.py:weight_spec``: stacked on a leading
  layer axis, linear weights transposed to [in, out]). Every tensor goes
  from the mapped shard straight into a preallocated stacked tensor on
  ``device`` (the card by default) in the config's dtype, so host memory
  holds about one shard at a time;
- ``load_vicuna``: the streaming path for a directory of ``.safetensors``
  files, ``torch.load(weights_only=True, mmap=True)`` for ``.bin`` files
  (one, or several under ``pytorch_model.bin.index.json``), then
  ``quantize_host_llama`` when asked;
- ``save_vicuna``: the inverse, an HF-layout directory (``config.json``,
  sharded ``.safetensors`` and their index) written with plain code.

The embedding table and lm_head grow to the tokenizer's vocabulary as HF's
``resize_token_embeddings`` does (reference models/modified_lm.py:75): the
new rows are the mean of the old ones, taken in numpy f32 as the JAX
package takes it, so the two packages give the same bits.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..convert import target_device
from .llama import LlamaConfig

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "F64": torch.float64,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}

# tensor-name -> (stack key, transpose) for per-layer weights
_LAYER_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def read_hf_config(path) -> Dict[str, Any]:
    """``config.json`` of an HF checkpoint directory, as a dict."""
    with open(Path(path) / "config.json", encoding="utf-8") as f:
        return json.load(f)


def config_from_hf(hf_config: Dict[str, Any],
                   vocab_size: Optional[int] = None,
                   **overrides) -> LlamaConfig:
    """LlamaConfig from an HF Llama ``config.json`` (a dict); missing
    fields take HF's LlamaConfig defaults."""
    c = hf_config
    heads = c.get("num_attention_heads", 32)
    kv = c.get("num_key_value_heads")
    return LlamaConfig(
        vocab_size=vocab_size or c.get("vocab_size", 32000),
        hidden_size=c.get("hidden_size", 4096),
        intermediate_size=c.get("intermediate_size", 11008),
        num_layers=c.get("num_hidden_layers", 32),
        num_heads=heads,
        num_kv_heads=heads if kv is None else kv,
        rope_theta=c.get("rope_theta", 10000.0),
        rms_norm_eps=c.get("rms_norm_eps", 1e-6),
        max_seq_len=c.get("max_position_embeddings", 2048),
        **overrides,
    )


class SafetensorsFile:
    """One ``.safetensors`` file, mapped; ``get_tensor`` returns views over
    the mapping. Each view holds the mapping, so the file is unmapped when
    the reader is closed and its last view is gone."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            n = struct.unpack("<Q", f.read(8))[0]
            header = json.loads(f.read(n))
            # a private mapping: writable for torch.frombuffer, and pages
            # are only read, never copied
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
                if os.fstat(f.fileno()).st_size else None
        header.pop("__metadata__", None)
        self.header = header
        self._base = 8 + n

    def keys(self):
        return list(self.header)

    def get_tensor(self, name: str) -> torch.Tensor:
        ent = self.header[name]
        code = ent["dtype"]
        if code not in _ST_DTYPES:
            raise ValueError(f"{self.path}: tensor {name} has dtype {code}, "
                             f"which this reader does not take "
                             f"({sorted(_ST_DTYPES)})")
        dt = _ST_DTYPES[code]
        start, end = ent["data_offsets"]
        shape = tuple(ent["shape"])
        if end == start:
            return torch.empty(shape, dtype=dt)
        itemsize = torch.empty((), dtype=dt).element_size()
        flat = torch.frombuffer(self._mm, dtype=dt,
                                count=(end - start) // itemsize,
                                offset=self._base + start)
        return flat.reshape(shape)

    def close(self):
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_safetensors(tensors: Dict[str, torch.Tensor], path,
                     metadata: Optional[Dict[str, str]] = None):
    """Write ``tensors`` (any device) as one ``.safetensors`` file."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)        # tensors start 8-byte aligned
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(memoryview(t.detach().contiguous().reshape(-1)
                                   .view(torch.uint8).cpu().numpy()))
    os.replace(tmp, path)


def _safetensors_files(path: Path):
    index = path / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        # a listed shard that is missing shows in the completeness check
        return sorted(f for f in set(weight_map.values())
                      if (path / f).exists())
    return sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))


def _safetensors_tensors(path: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    for fname in _safetensors_files(path):
        with SafetensorsFile(path / fname) as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def _bin_tensors(path: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    if path.is_file():
        files = [path]
    else:
        index = path / "pytorch_model.bin.index.json"
        if index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            files = [path / f for f in sorted(set(weight_map.values()))]
        else:
            files = sorted(path.glob("*.bin"))
    if not files:
        raise FileNotFoundError(
            f"no checkpoint at {path}: expected *.safetensors (with or "
            f"without model.safetensors.index.json) or pytorch_model*.bin")
    for fname in files:
        sd = torch.load(fname, map_location="cpu", weights_only=True,
                        mmap=True)
        yield from sd.items()
        del sd


def _resize_rows(table: torch.Tensor, new_rows: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 transpose: bool = False) -> torch.Tensor:
    """Grow (or cut) a [V, H] table to ``new_rows`` rows in ``dtype`` on
    ``device`` ([H, new_rows] with ``transpose``): rows past V are the mean
    of the V rows (HF semantics), taken in numpy f32 as the JAX package
    takes it."""
    v, h = table.shape
    out = torch.empty((h, new_rows) if transpose else (new_rows, h),
                      dtype=dtype or table.dtype,
                      device=device or table.device)
    n = min(v, new_rows)
    src = table[:n].to(out.device)
    if transpose:
        out[:, :n].copy_(src.t())
    else:
        out[:n].copy_(src)
    if new_rows > v:
        mean = torch.from_numpy(table.float().cpu().numpy().mean(axis=0))
        mean = mean.to(device=out.device, dtype=out.dtype)
        if transpose:
            out[:, v:].copy_(mean[:, None].expand(-1, new_rows - v))
        else:
            out[v:].copy_(mean[None].expand(new_rows - v, -1))
    return out


def _convert(tensors, cfg: LlamaConfig, device, path) -> Dict[str, Any]:
    """The (name, tensor) stream of an HF Llama state dict -> the port's
    tree on ``device`` in ``cfg.dtype``."""
    L, h, i = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt, V = cfg.dtype, cfg.vocab_size

    def empty(*shape):
        return torch.empty(shape, dtype=dt, device=device)

    layers = {"attn_norm": empty(L, h), "wq": empty(L, h, nh * d),
              "wk": empty(L, h, nkv * d), "wv": empty(L, h, nkv * d),
              "wo": empty(L, nh * d, h), "mlp_norm": empty(L, h),
              "w_gate": empty(L, h, i), "w_up": empty(L, h, i),
              "w_down": empty(L, i, h)}
    params: Dict[str, Any] = {"layers": layers}
    seen = set()
    with torch.no_grad():
        for name, w in tensors:
            seen.add(name)
            if name == "model.embed_tokens.weight":
                params["embed"] = _resize_rows(w, V, dt, device)
            elif name == "lm_head.weight":
                params["lm_head"] = _resize_rows(w, V, dt, device,
                                                 transpose=True)
            elif name == "model.norm.weight":
                params["final_norm"] = empty(h)
                params["final_norm"].copy_(w)
            elif name.startswith("model.layers."):
                lidx, _, key = name[len("model.layers."):].partition(".")
                ent = _LAYER_MAP.get(key)
                if ent is None:
                    continue       # rotary inv_freq buffers etc.
                stack, transpose = ent
                # to the device as stored, then transposed there
                w = w.to(device)
                layers[stack][int(lidx)].copy_(w.t() if transpose else w)
    # completeness: a missing shard would otherwise leave uninitialised
    # layers (the failure mode of a partial download of the multi-file
    # layout)
    expected = {"model.embed_tokens.weight", "model.norm.weight"} | {
        f"model.layers.{l}.{k}" for l in range(L) for k in _LAYER_MAP}
    missing = expected - seen
    if missing:
        raise ValueError(
            f"checkpoint at {path} is incomplete: {len(missing)} tensors "
            f"missing (e.g. {sorted(missing)[:3]}) — partial download?")
    if "lm_head" not in params:     # tied embeddings
        params["lm_head"] = params["embed"].t().contiguous()
    return params


def load_vicuna_streaming(path, vocab_size: int,
                          dtype: Optional[torch.dtype] = None,
                          device=None) -> tuple:
    """Convert a local (sharded) safetensors Llama checkpoint without
    building an HF model: each tensor streams out of its mapped shard into
    the preallocated stacked tree on ``device`` (default: the card).
    Returns (LlamaConfig, params)."""
    path = Path(path)
    cfg = config_from_hf(read_hf_config(path), vocab_size=vocab_size,
                         dtype=dtype or torch.bfloat16)
    return cfg, _convert(_safetensors_tensors(path), cfg,
                         target_device(device), path)


def load_vicuna(pretrained_model_name_or_path, vocab_size: int,
                dtype: Optional[torch.dtype] = None, quantize: bool = False,
                quant_bits: int = 8, device=None) -> tuple:
    """Load a local Vicuna/Llama checkpoint -> (LlamaConfig, params) on
    ``device`` (default: the card).

    A directory of ``.safetensors`` files streams (load_vicuna_streaming);
    ``.bin`` checkpoints are read through ``torch.load(weights_only=True,
    mmap=True)`` into the same tree. ``quantize=True`` then converts the
    layer matmuls to int8 (or group-wise int4 with ``quant_bits=4``) and
    embed and lm_head to int8, one weight at a time
    (models/quant.py:quantize_host_llama)."""
    p = Path(pretrained_model_name_or_path)
    if p.is_dir() and any(f.endswith(".safetensors") for f in os.listdir(p)):
        cfg, params = load_vicuna_streaming(p, vocab_size, dtype=dtype,
                                            device=device)
    else:
        cfg = config_from_hf(read_hf_config(p if p.is_dir() else p.parent),
                             vocab_size=vocab_size,
                             dtype=dtype or torch.bfloat16)
        params = _convert(_bin_tensors(p), cfg, target_device(device), p)
    if quantize:
        from .quant import quantize_host_llama
        params = quantize_host_llama(params, bits=quant_bits)
    return cfg, params


def save_vicuna(path, params, cfg: LlamaConfig,
                vocab_rows: Optional[int] = None,
                shard_bytes: int = 5 * 10 ** 9) -> Dict[str, Any]:
    """Write a dense LLM tree as an HF-layout Llama checkpoint directory:
    ``config.json``, ``model-0000k-of-0000n.safetensors`` shards of at most
    ``shard_bytes`` (a tensor never splits) and
    ``model.safetensors.index.json``. Weights go back to HF names and
    [out, in]; the first ``vocab_rows`` rows of embed and lm_head (default:
    all) are written, and ``config.json`` says that vocabulary. Returns the
    index."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    V = vocab_rows or cfg.vocab_size
    names = {v[0]: (k, v[1]) for k, v in _LAYER_MAP.items()}

    def tensors():
        yield "model.embed_tokens.weight", params["embed"][:V]
        for l in range(cfg.num_layers):
            for stack, (key, transpose) in names.items():
                w = params["layers"][stack][l]
                yield f"model.layers.{l}.{key}", w.t() if transpose else w
        yield "model.norm.weight", params["final_norm"]
        yield "lm_head.weight", params["lm_head"][:, :V].t()

    shards, cur, size = [], {}, 0
    for name, t in tensors():
        nbytes = t.numel() * t.element_size()
        if cur and size + nbytes > shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[name] = t
        size += nbytes
    shards.append(cur)
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_safetensors({n: t.contiguous() for n, t in shard.items()},
                         path / fname, metadata={"format": "pt"})
        for n, t in shard.items():
            weight_map[n] = fname
            total += t.numel() * t.element_size()
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    (path / "model.safetensors.index.json").write_text(json.dumps(index))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": V, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "hidden_act": "silu", "tie_word_embeddings": False,
        "torch_dtype": str(params["layers"]["wq"].dtype).split(".")[-1]},
        indent=2))
    return index
