"""The augmented R2R and REVERIE datasets for the port (twin of
navillm_tpu/data/datasets/aug.py; reference r2r_aug.py, reverie_aug.py).

Their ``.jsonl`` annotations carry bert-base-uncased token ids
(``instr_encoding``) instead of text, which the class attribute
``decoder`` (ids -> str) turns back into the instruction when set. The
default decoder is bert-base-uncased's ``decode(ids,
skip_special_tokens=True)``, read from the local Hugging Face cache as
``transformers.AutoTokenizer.from_pretrained("bert-base-uncased")`` finds
it offline (``bert_cache_snapshot``), without the network, transformers or
huggingface_hub. A debug run reads the first 20 lines. A ``.json`` file
falls through to the parent loader (R2R's or REVERIE's). The
REVERIE set's ``pos_vps`` become its end viewpoints and it has no target
object (objId None), so neither its evaluation nor the object-grounding
head has one to ground.
"""
from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from typing import Callable, List, Optional

from ..models.tokenization import WordPieceDecoder
from .r2r import R2RDataset
from .reverie import REVERIEDataset

BERT_REPO = "bert-base-uncased"


def hf_hub_cache() -> Path:
    """The hub cache transformers reads when given no ``cache_dir``, as
    transformers.utils.hub and huggingface_hub.constants resolve it:
    ``TRANSFORMERS_CACHE``, ``PYTORCH_TRANSFORMERS_CACHE`` or
    ``PYTORCH_PRETRAINED_BERT_CACHE``, else ``HF_HUB_CACHE`` or
    ``HUGGINGFACE_HUB_CACHE``, else ``$HF_HOME/hub``, where ``HF_HOME``
    defaults to ``$XDG_CACHE_HOME/huggingface`` and that to
    ``~/.cache/huggingface``."""
    env = os.environ
    for k in ("TRANSFORMERS_CACHE", "PYTORCH_TRANSFORMERS_CACHE",
              "PYTORCH_PRETRAINED_BERT_CACHE"):
        if k in env:
            return Path(env[k])
    xdg = env.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"),
                                                 ".cache"))
    home = os.path.expandvars(os.path.expanduser(
        env.get("HF_HOME", os.path.join(xdg, "huggingface"))))
    hub = env.get("HF_HUB_CACHE", env.get("HUGGINGFACE_HUB_CACHE",
                                          os.path.join(home, "hub")))
    return Path(os.path.expandvars(os.path.expanduser(hub)))


def bert_cache_snapshot() -> Path:
    """The snapshot directory of bert-base-uncased that an offline
    ``from_pretrained("bert-base-uncased")`` reads:
    ``<hub>/models--bert-base-uncased/refs/main`` names the revision,
    ``snapshots/<revision>/`` holds the files. Raises FileNotFoundError,
    naming where it looked, when the snapshot has neither
    ``tokenizer.json`` nor ``vocab.txt``."""
    hub = hf_hub_cache()
    root = hub / f"models--{BERT_REPO}"
    ref = root / "refs" / "main"
    snap = root / "snapshots" / ref.read_text().strip() \
        if ref.is_file() else None
    if snap is None or not any((snap / f).is_file()
                               for f in ("tokenizer.json", "vocab.txt")):
        raise FileNotFoundError(
            f"{BERT_REPO}'s vocab.txt is not in the Hugging Face cache: "
            f"looked in {hub} (HF_HUB_CACHE, else $HF_HOME/hub), for {ref} "
            f"and the snapshot it names "
            f"({snap if snap is not None else root / 'snapshots'}) with "
            f"vocab.txt or tokenizer.json. Download {BERT_REPO} there, set "
            f"the dataset class's `decoder` (ids -> str), or give the split "
            f"a .json annotation file")
    return snap


@functools.lru_cache(maxsize=4)
def _snapshot_decoder(snap: Path) -> WordPieceDecoder:
    return WordPieceDecoder(snap)


def _default_decoder() -> Callable[[List[int]], str]:
    """bert-base-uncased's ``decode(ids, skip_special_tokens=True)`` over
    the cache's snapshot (read once per snapshot)."""
    return _snapshot_decoder(bert_cache_snapshot())


def _read_jsonl(anno_file, debug):
    data = []
    with open(str(anno_file)) as f:
        for i, line in enumerate(f):
            if debug and i == 20:
                break
            line = line.strip()
            if line:
                data.append(json.loads(line))
    return data


class R2RAugDataset(R2RDataset):
    name = "r2r_aug"
    decoder: Optional[Callable[[List[int]], str]] = None

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        if str(anno_file).endswith(".json"):
            return super().load_data(anno_file, max_instr_len=max_instr_len,
                                     debug=debug)
        decoder = self.decoder or _default_decoder()
        new_data = []
        for i, item in enumerate(_read_jsonl(anno_file, debug)):
            new_item = dict(item)
            new_item["raw_idx"] = i
            new_item["sample_idx"] = i
            new_item["data_type"] = "r2r_aug"
            new_item["path_id"] = None
            new_item["heading"] = item.get("heading", 0)
            new_item["instruction"] = decoder(new_item["instr_encoding"])
            new_data.append(new_item)
        if debug:
            new_data = new_data[:20]
        gt_trajs = {x["instr_id"]: (x["scan"], x["path"])
                    for x in new_data if len(x["path"]) > 1}
        return new_data, gt_trajs


class REVERIEAugDataset(REVERIEDataset):
    name = "reverie_aug"
    decoder: Optional[Callable[[List[int]], str]] = None

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        if str(anno_file).endswith(".json"):
            return super().load_data(anno_file, debug=debug)
        decoder = self.decoder or _default_decoder()
        new_data = []
        for i, item in enumerate(_read_jsonl(anno_file, debug)):
            new_item = dict(item)
            new_item["raw_idx"] = i
            new_item["sample_idx"] = i
            new_item["data_type"] = "reverie_aug"
            new_item["instruction"] = decoder(new_item["instr_encoding"])
            new_item["objId"] = None
            new_item["path_id"] = None
            new_item["heading"] = item.get("heading", 0)
            new_item["end_vps"] = item["pos_vps"]
            del new_item["pos_vps"]
            new_data.append(new_item)
        if debug:
            new_data = new_data[:20]
        gt_trajs = {x["instr_id"]: (x["scan"], x["path"], x["objId"])
                    for x in new_data if x.get("objId") is not None}
        return new_data, gt_trajs
