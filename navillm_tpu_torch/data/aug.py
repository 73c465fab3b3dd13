"""The augmented R2R and REVERIE datasets for the port (twin of
navillm_tpu/data/datasets/aug.py; reference r2r_aug.py, reverie_aug.py).

Their ``.jsonl`` annotations carry bert-base-uncased token ids
(``instr_encoding``) instead of text, which the class attribute
``decoder`` (ids -> str) turns back into the instruction. The repository
holds no bert-base-uncased vocabulary yet, so the default decoder raises;
tests inject one. A debug run reads the first 20 lines. A ``.json`` file
falls through to the parent loader (R2R's or REVERIE's). The
REVERIE set's ``pos_vps`` become its end viewpoints and it has no target
object (objId None), so neither its evaluation nor the object-grounding
head has one to ground.
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional

from .r2r import R2RDataset
from .reverie import REVERIEDataset


def _default_decoder() -> Callable[[List[int]], str]:
    raise NotImplementedError(
        "decoding .jsonl augmented annotations (bert-base-uncased token "
        "ids) needs bert-base-uncased's vocab.txt in the repository, which "
        "it does not hold yet: set the dataset class's `decoder` (ids -> "
        "str), or give the split a .json annotation file")


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
