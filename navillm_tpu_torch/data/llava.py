"""LLaVA instruction-tuning dataset for the port (twin of
navillm_tpu/data/datasets/llava.py; reference tasks/datasets/llava.py).

LLaVA-detail-23k: one sample per human/gpt turn pair of a conversation
(the question without its <image> tag, the answer), over the COCO image's
features from the ``coco`` feature store, read as ``np.stack(feature)[None]``
(one frame). No scores: it is a training set only.
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Optional

import numpy as np


class LLaVADataset:
    name = "llava"

    def __init__(self, anno_file, split: str = "train",
                 max_datapoints: Optional[int] = None, logger=None):
        self.split = split
        self.logger = logger
        self.max_datapoints = max_datapoints
        self.feat_db = None
        self.obj_feat_db = None
        self._load_data(anno_file)

    def init_feat_db(self, feat_db, obj_feat_db=None):
        self.feat_db = feat_db
        self.obj_feat_db = obj_feat_db

    def _load_data(self, anno_file):
        with open(str(anno_file)) as f:
            data = json.load(f)
        self.alldata = []
        for item in data:
            conversations = item["conversations"]
            if len(conversations) != 2:
                raise ValueError(f"{item['id']}: the round of conversation "
                                 f"must be 2, not {len(conversations)}")
            for i in range(0, len(conversations) - 1, 2):
                if (conversations[i]["from"], conversations[i + 1]["from"]) \
                        != ("human", "gpt"):
                    raise ValueError(f"{item['id']}: turn {i // 2} is not a "
                                     f"human question and a gpt answer")
                self.alldata.append({
                    "id": item["id"],
                    "turn_id": i // 2,
                    "image_id": item["image"].split(".")[0],
                    "question": conversations[i]["value"]
                        .replace("<image>", "").strip(),
                    "answers": [conversations[i + 1]["value"]],
                })
        self._cut_and_log()

    def _cut_and_log(self):
        if self.max_datapoints:
            self.alldata = self.alldata[: self.max_datapoints]
        if self.logger is not None:
            self.logger.info(
                f"There are totally {len(self.alldata)} datapoints loaded.")

    def __len__(self):
        return len(self.alldata)

    def __getitem__(self, index):
        item = copy.deepcopy(self.alldata[index])
        features = self.feat_db.get_image_feature(item["image_id"])
        features = np.stack(features)[None]
        return {"id": item["id"], "image_id": item["image_id"],
                "question": item["question"], "answers": item["answers"],
                "data_type": "llava", "features": features}

    @staticmethod
    def collate_batch(batch_list, _unused=False):
        data_dict = defaultdict(list)
        for sample in batch_list:
            for k, v in sample.items():
                data_dict[k].append(v)
        ret = dict(data_dict)
        ret["batch_size"] = len(batch_list)
        return ret

    def eval_metrics(self, preds, logger, name):
        return {}, {}

    def save_json(self, results, path, item_metrics=None):
        with open(path, "w") as f:
            json.dump(results, f)
