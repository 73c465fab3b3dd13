"""ScanQA 3D question answering for the port (twin of
navillm_tpu/data/datasets/scanqa.py; reference tasks/datasets/scanqa.py).

The reformatted ScanQA annotations: one sample per question of a scene
(answers lower-cased), each read with up to 36 of the scene's ScanNet
frames, drawn by Python's global ``random.sample`` at every read, as JAX
draws them, from the ``scan_qa`` feature store (keyed scene_frame).
``eval_metrics`` scores the first generated sentence against the answers:
BLEU-1..4, ROUGE-L, CIDEr (METEOR where its jar runs) and exact match, all
in percent; ``save_json`` writes the leaderboard's format.
"""
from __future__ import annotations

import copy
import json
import random

import numpy as np

from ..eval.captioning import Bleu, Cider, Meteor, Rouge
from .llava import LLaVADataset

# frames per question (reference scanqa.py:62)
MAX_FRAMES = 36


class ScanQADataset(LLaVADataset):
    name = "scanqa"

    def _load_data(self, anno_file):
        self.alldata = []
        with open(str(anno_file)) as f:
            data = json.load(f)
        for item in data:
            for ann in item["annotation"]:
                self.alldata.append({
                    "question_id": ann["question_id"],
                    "question": ann["question"],
                    "answers": [a.lower() for a in ann["answers"]],
                    "image_info": item["image_info"],
                    "scene_id": item["scene_id"],
                })
        self._cut_and_log()

    def __getitem__(self, index):
        item = copy.deepcopy(self.alldata[index])
        sampled = random.sample(item["image_info"],
                                min(MAX_FRAMES, len(item["image_info"])))
        features = np.stack([
            self.feat_db.get_image_feature(item["scene_id"], d["image_id"])
            for d in sampled])
        return {"scene_id": item["scene_id"],
                "question_id": item["question_id"],
                "question": item["question"], "answers": item["answers"],
                "features": features, "data_type": "scan_qa"}

    def eval_metrics(self, preds, logger, name):
        ret = {}
        if self.split == "test":
            return ret, {}
        refs = {item["question_id"]: item["answers"] for item in self.alldata}
        gen = {item["question_id"]: item["generated_sentences"]
               for item in preds}
        score, _ = Bleu().compute_score(refs, gen)
        for i, s in enumerate(score):
            ret[f"bleu-{i+1}"] = s * 100
        score, _ = Rouge().compute_score(refs, gen)
        ret["rouge"] = score * 100
        score, _ = Cider().compute_score(refs, gen)
        ret["cider"] = score * 100
        meteor = Meteor()
        if meteor.available():
            score, _ = meteor.compute_score(refs, gen)
            ret["meteor"] = score * 100

        metrics = {"exact_match": []}
        n_correct = 0
        for pred in preds:
            hit = pred["generated_sentences"][0] in refs[pred["question_id"]]
            n_correct += int(hit)
            metrics["exact_match"].append(float(hit))
        ret["exact_match"] = n_correct / len(preds) * 100
        return ret, metrics

    def save_json(self, results, path, item_metrics=None):
        """Leaderboard format (reference scanqa.py:100-107)."""
        for item in results:
            item["answer_top10"] = item["generated_sentences"]
            item["pred_bbox"] = []
            del item["generated_sentences"]
        with open(path, "w") as f:
            json.dump(results, f)
