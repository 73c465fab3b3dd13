"""The non-embodied agents: LLaVA instruction tuning and ScanQA 3D-QA.

Torch twin of navillm_tpu/agents/llava_agent.py (reference
tasks/agents/llava.py:19-85, scanqa.py:7-20). A batch's frame features
(one COCO image, or up to 36 ScanNet frames) go through the panorama
encoder as views with zero location features and navigation type 1, then
the zero-position fusion, into the LLM at the prompt's <cand> tokens (one
zero history embed at its absent <hist>). ``train``: the teacher-forced
answer loss through runner.pano_generation_train, one autograd graph from
the LLM's loss back into the panorama encoder (K1 forward, K2/K3
backward). ``validate`` (ScanQA): the host panorama (runner.panorama),
then at most 20 generated tokens per question (runner.generate: one K1
prefill, then the eager decode loop; no trie).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.decoding import decode_to_text
from ..utils.registry import AGENTS
from . import prompts as P
from .runner import NavModelRunner, RolloutDims


@AGENTS.register("llava")
class LLaVAAgent:
    def __init__(self, args, world=None, runner: NavModelRunner = None,
                 dims: Optional[RolloutDims] = None):
        self.args = args
        self.runner = runner
        self.dims = dims or runner.dims

    def get_prompt(self, task, ques, cand_num):
        assert task == "3dqa"
        return P.llava_3dqa_prompt(ques, cand_num)

    def prepare_prompts(self, batch):
        return [self.get_prompt("3dqa", ques=q, cand_num=f.shape[0])
                for q, f in zip(batch["question"], batch["features"])]

    def _pano_batch(self, batch):
        """Ragged frame features -> [B, F, D] views with their lens, zero
        location features and navigation type 1."""
        feats = batch["features"]
        b = len(feats)
        fmax = max(f.shape[0] for f in feats)
        D = feats[0].shape[-1]
        view = np.zeros((b, fmax, D), np.float32)
        lens = np.zeros((b,), np.int32)
        for i, f in enumerate(feats):
            f = np.asarray(f, np.float32).reshape(-1, D)
            view[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        return {"view_img_fts": view, "view_lens": lens,
                "loc_fts": np.zeros((b, fmax, self.args.angle_feat_size + 3),
                                    np.float32),
                "nav_types": np.ones((b, fmax), np.int32)}

    def train(self, name, batch, args, config, dataset=None, step=0,
              **kwargs):
        """One batch's answer loss and gradient (the panorama encoder's
        included). Returns the loss, a device scalar, times
        gradient_accumulation_step, as the other agents do."""
        assert name in ("ScanQA", "LLaVA")
        stage_cfg = config.Pretrain if args.stage == "pretrain" \
            else config.Multi
        loss_coef = (getattr(stage_cfg, "LOSS_COEF", None) or {}) \
            .get(name, 1.0)
        prompts = self.prepare_prompts(batch)
        answers = [a[0] for a in batch["answers"]]
        pano_in = self._pano_batch(batch)
        seed = self.runner.next_seed()
        host_masks = (np.arange(pano_in["view_img_fts"].shape[1])[None, :]
                      < pano_in["view_lens"][:, None])
        texts = [[p, a + self.runner.tok.eos_token]
                 for p, a in zip(prompts, answers)]
        C = int(host_masks.sum(1).max())
        tok_batch, cand_pos, hist_pos, _ = \
            self.runner.tokenize_with_positions(texts, max_cands=max(C, 1),
                                                max_hist=1)
        labels = tok_batch.input_ids.astype(np.int64)
        labels[tok_batch.token_type_ids == 0] = args.ignoreid
        b = len(prompts)
        gen_batch = {
            "input_ids": tok_batch.input_ids,
            "attention_mask": tok_batch.attention_mask,
            "labels": labels,
            "vp_masks": host_masks,
            "cand_positions": cand_pos,
            "hist_positions": hist_pos,
            "hist_embeds": np.zeros(
                (b, 1, self.runner.cfg.hidden_size), np.float32),
        }
        loss = self.runner.pano_generation_train(
            pano_in, seed, gen_batch,
            coef=loss_coef / args.gradient_accumulation_step)
        return loss * args.gradient_accumulation_step

    def validate(self, name, args, config, loader, dataset=None, **kwargs):
        """Generated answers, greedy (or sampled with do_sample), for every
        question of ``loader``: [{scene_id, question_id,
        generated_sentences: [answer]}]."""
        assert name in ("ScanQA",)
        preds: List[Dict] = []
        hidden = self.runner.cfg.hidden_size
        for batch in loader:
            prompts = self.prepare_prompts(batch)
            pano_in = self._pano_batch(batch)
            pano_out = self.runner.panorama(pano_in, deterministic=True)
            C = int(pano_out["pano_masks"].sum(1).max())
            tok_batch, cand_pos, hist_pos, _ = \
                self.runner.tokenize_with_positions(prompts,
                                                    max_cands=max(C, 1),
                                                    max_hist=1)
            emb = self.runner.gen_embeds(pano_out["pano_embeds"],
                                         pano_out["pano_masks"])
            b = len(prompts)
            inj_pos = np.concatenate([cand_pos, hist_pos], 1)
            inj_emb = torch.cat(
                [emb[:, : cand_pos.shape[1]].float(),
                 emb.new_zeros((b, 1, hidden), dtype=torch.float32)], 1)
            gen_ids = self.runner.generate(
                tok_batch.input_ids, tok_batch.attention_mask, inj_pos,
                inj_emb, max_new_tokens=20, do_sample=args.do_sample,
                temperature=args.temperature)
            sentences = decode_to_text(self.runner.tok, gen_ids)
            for i in range(len(batch["question"])):
                preds.append({
                    "scene_id": batch["scene_id"][i],
                    "question_id": batch["question_id"][i],
                    "generated_sentences": [sentences[i].lower().strip()],
                })
        return preds


@AGENTS.register("scanqa")
class ScanQAAgent(LLaVAAgent):
    def get_prompt(self, task, ques, cand_num):
        assert task == "3dqa"
        return P.threedqa_prompt(ques, cand_num)
