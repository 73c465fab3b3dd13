"""EQA (MP3D-EQA) dataset for the port (twin of
navillm_tpu/data/datasets/eqa.py).

Closed-vocabulary embodied QA on the R2R dataset's machinery: one sample
per annotation item, ids eqa_<sample_idx>_<i>, the question text as the
observation's instruction and the answer text beside it; eval_metrics adds
exact_match and oracle_exact_match (the answers of the oracle pass) to the
navigation metrics. ``answer_vocab`` is the closed answer vocabulary
(ANSWER_VOCAB of the task config), from which the agent builds its trie.
"""
from __future__ import annotations

import json
from typing import Any, List, Optional

from .r2r import R2RDataset


class EQADataset(R2RDataset):
    name = "eqa"

    def __init__(self, anno_file, world, answer_vocab: List[str], **kw):
        super().__init__(anno_file, world, **kw)
        self.answer_vocab = list(answer_vocab)

    def load_data(self, anno_file, max_instr_len=200, debug=False):
        with open(str(anno_file)) as f:
            data = json.load(f)
        new_data = []
        for i, item in enumerate(data):
            new_item = dict(item)
            new_item["raw_idx"] = item["sample_idx"]
            new_item["instr_id"] = "eqa_{}_{}".format(item["sample_idx"], i)
            new_item["path_id"] = item["sample_idx"]
            new_item["data_type"] = "eqa"
            new_item["heading"] = 0.0
            new_data.append(new_item)
        if debug:
            new_data = new_data[:20]
        gt_trajs = {x["instr_id"]: (x["scan"], x["path"])
                    for x in new_data if len(x["path"]) > 1}
        return new_data, gt_trajs

    def get_obs(self, items, env, data_type=None):
        """The question replaces the instruction; the answer rides along."""
        obs = super().get_obs(items, env, data_type)
        for ob, item in zip(obs, items):
            ob["instruction"] = item["question"]["question_text"]
            ob["answer"] = item["question"]["answer_text"]
        return obs

    def eval_metrics(self, preds, logger: Optional[Any], name: str):
        """(aggregate navigation metrics + exact_match and
        oracle_exact_match in percent, per-item metric lists)."""
        avg, metrics = super().eval_metrics(preds, logger, name)
        gt = {p["instr_id"]: [p["gt_answer"]] for p in preds}
        avg["exact_match"] = sum(
            p["pred_answer"] in gt[p["instr_id"]] for p in preds) \
            / len(preds) * 100
        avg["oracle_exact_match"] = sum(
            p["oracle_pred_answer"] in gt[p["instr_id"]] for p in preds) \
            / len(preds) * 100
        return avg, metrics

    def save_json(self, results, path, item_metrics=None):
        with open(path, "w") as f:
            json.dump(results, f)
