"""Caption metrics: BLEU-1..4, ROUGE-L, CIDEr-D, optional METEOR.

The port's copy of navillm_tpu/eval/captioning.py, with the same names and
numerics (the coco-caption algorithms the reference vendors under
tools/evaluation/{bleu,rouge,cider,meteor}):
  - BLEU: corpus-level, clipped n-gram counts, 'closest' reference
    length, tiny/small epsilon smoothing, brevity penalty on corpus
    totals (bleu.py:40 uses option='closest');
  - ROUGE-L: LCS F-measure with beta=1.2, max over refs, mean over
    items;
  - CIDEr-D: tf-idf 4-gram cosine with count clipping and gaussian
    length penalty sigma=6, corpus idf from refs, x10 scaling
    (cider_scorer.py:126-160), including the upstream quirk that
    "length" is the *bigram* total (cider_scorer.py:110-111);
  - METEOR: the Java jar's stdin/stdout line protocol
    (meteor/meteor.py:53-82), only where java and the jar are there:
    .available() says so, and ScanQA leaves METEOR out otherwise.

compute_score(gts, res) -> (score, scores), where gts/res map id ->
list[str] (res lists hold one hypothesis).
"""
from __future__ import annotations

import math
import os
import shutil
import subprocess
import threading
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        small, tiny = 1e-9, 1e-15
        total_correct = [0.0] * self.n
        total_guess = [0.0] * self.n
        total_testlen = 0
        total_reflen = 0
        per_item_stats = []

        for k in gts:
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            testlen = len(hyp)
            # 'closest' reference length (ties -> shorter)
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            correct, guess = [], []
            for n in range(1, self.n + 1):
                hyp_ng = _ngrams(hyp, n)
                max_ref = Counter()
                for r in refs:
                    for ng, c in _ngrams(r, n).items():
                        max_ref[ng] = max(max_ref[ng], c)
                correct.append(float(sum(min(c, max_ref[ng])
                                         for ng, c in hyp_ng.items())))
                guess.append(float(max(0, testlen - n + 1)))
            total_testlen += testlen
            total_reflen += reflen
            for n in range(self.n):
                total_correct[n] += correct[n]
                total_guess[n] += guess[n]
            per_item_stats.append((correct, guess, testlen, reflen))

        def bleus(correct, guess, testlen, reflen):
            out = []
            p = 1.0
            for n in range(self.n):
                p *= (correct[n] + tiny) / (guess[n] + small)
                out.append(p ** (1.0 / (n + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                bp = math.exp(1 - 1 / ratio)
                out = [b * bp for b in out]
            return out

        score = bleus(total_correct, total_guess, total_testlen, total_reflen)
        scores = [bleus(c, g, t, r) for c, g, t, r in per_item_stats]
        scores = [list(x) for x in zip(*scores)]    # [n][item]
        return score, scores


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        best = 0.0
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec = lcs / len(hyp) if hyp else 0.0
            rec = lcs / len(r) if r else 0.0
            if prec != 0 and rec != 0:
                f = ((1 + self.beta ** 2) * prec * rec) / \
                    (rec + self.beta ** 2 * prec)
            else:
                f = 0.0
            best = max(best, f)
        return best

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[k], gts[k]) for k in gts]
        return float(np.mean(scores)), np.asarray(scores)


class Cider:
    """CIDEr-D: clipped tf-idf cosine + gaussian length penalty."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        keys = list(gts.keys())
        crefs = [[_counts(r, self.n) for r in gts[k]] for k in keys]
        ctest = [_counts(res[k][0], self.n) for k in keys]

        doc_freq: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ng in set(ng for ref in refs for ng in ref):
                doc_freq[ng] += 1
        ref_len = np.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ng, tf in cnts.items():
                df = np.log(max(1.0, doc_freq[ng]))
                n = len(ng) - 1
                vec[n][ng] = float(tf) * (ref_len - df)
                norm[n] += vec[n][ng] ** 2
                if n == 1:          # upstream quirk: bigram total = "length"
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = np.zeros(self.n)
            for n in range(self.n):
                for ng in vh[n]:
                    val[n] += min(vh[n][ng], vr[n][ng]) * vr[n][ng]
                if nh[n] != 0 and nr[n] != 0:
                    val[n] /= nh[n] * nr[n]
                val[n] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = counts2vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                score += sim(vec, vr, norm, nr, length, lr)
            scores.append(float(np.mean(score) / len(refs) * 10.0))
        return float(np.mean(scores)), np.asarray(scores)


def _counts(sentence: str, n: int) -> Counter:
    words = sentence.split()
    out = Counter()
    for k in range(1, n + 1):
        out.update(tuple(words[i:i + k]) for i in range(len(words) - k + 1))
    return out


class Meteor:
    """METEOR 1.5 via the Java jar's line protocol (optional).

    Looks for meteor-1.5.jar next to this file or at $METEOR_JAR;
    .available() reports whether java and the jar are there.
    """

    def __init__(self):
        here = os.path.dirname(os.path.abspath(__file__))
        self.jar = os.environ.get("METEOR_JAR",
                                  os.path.join(here, "meteor-1.5.jar"))
        self._proc = None
        self._lock = threading.Lock()

    def available(self) -> bool:
        return shutil.which("java") is not None and os.path.exists(self.jar)

    def _ensure_proc(self):
        if self._proc is None:
            self._proc = subprocess.Popen(
                ["java", "-jar", "-Xmx2G", self.jar, "-", "-", "-stdio",
                 "-l", "en", "-norm"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                universal_newlines=True, bufsize=1)

    def compute_score(self, gts: Dict, res: Dict):
        if not self.available():
            raise RuntimeError("METEOR jar/java not available")
        assert gts.keys() == res.keys()
        keys = list(gts.keys())
        with self._lock:
            self._ensure_proc()
            eval_line = "EVAL"
            for k in keys:
                stat_line = "SCORE ||| {} ||| {}".format(
                    " ||| ".join(r.replace("|||", "").replace("  ", " ")
                                 for r in gts[k]),
                    res[k][0].replace("|||", "").replace("  ", " "))
                self._proc.stdin.write(stat_line + "\n")
                stats = self._proc.stdout.readline().strip()
                eval_line += " ||| {}".format(stats)
            self._proc.stdin.write(eval_line + "\n")
            scores = [float(self._proc.stdout.readline().strip())
                      for _ in keys]
            final = float(self._proc.stdout.readline().strip())
        return final, np.asarray(scores)

    def close(self):
        if self._proc is not None:
            self._proc.kill()
            self._proc = None
