"""Synthetic worlds and batches for the port's tests and chip_smoke.py.

``make_grid_connectivity`` and ``synthetic_nav_batch`` follow
navillm_tpu/testing.py (the port imports nothing of the JAX package).
``make_r2r_world`` writes a grid world with R2R annotations (with FGR2R
chunks), as bench.py's rollout world does, and beside them EQA, REVERIE,
SOON and CVDN annotations on the same grid, ScanQA questions and LLaVA
conversations, and the augmented R2R and REVERIE sets (``.jsonl`` token
ids that ``aug_decoder`` reads, and ``.json``); ``r2r_eval``,
``eqa_eval``, ``reverie_eval``, ``soon_eval``, ``cvdn_eval`` and
``scanqa_eval`` wire the port's evaluation over it, ``r2r_train`` its
teacher-forcing training, and ``feature_dbs`` the synthetic stores of
every task. ``write_hdf5_features`` writes a world's view features as the
extractors write them (the port's HDF5 writer), for ``ImageFeaturesDB``;
``write_npy_features`` and ``NpyFeaturesDB`` give a disk-backed store of
one ``.npy`` per viewpoint with the same reads and cache;
``hold_off_prefetch`` keeps an agent from prefetching.
``spawn_gloo`` runs a function in N processes joined by a gloo process
group (the multi-process tests and rehearsals on the CPU).
``spm_pieces`` and ``write_sentencepiece_model`` write seeded
sentencepiece models; ``llama3_tokenizer_spec`` grows a LLaMA-3-layout
``tokenizer.json`` to LLaMA-3's 128000 entries and
``write_llama3_checkpoint`` writes a Meta-Llama-3-8B-shaped directory
without weights around it.
"""
from __future__ import annotations

import json
import math
import random
import struct
import threading
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import numpy as np

from .data.feature_db import (ImageFeaturesDB, SyntheticImageFeaturesDB,
                              _SyntheticObjectStore)
from .data.loaders import Dataloader
from .sim import ScanGraph, WorldModel

_VERBS = "walk turn go continue head move proceed pass".split()
_DIRS = "left right straight forward around back".split()
_ROOMS = "kitchen bedroom bathroom hallway lounge office foyer".split()
_OBJECTS = ("sofa table chair lamp bed door window mirror sink stairs "
            "counter cabinet rug plant").split()


def make_grid_connectivity(tmpdir, scan: str = "scan0", rows: int = 4,
                           cols: int = 4, spacing: float = 2.0) -> Path:
    """Matterport-style connectivity JSON for a 4-connected grid world:
    node (r, c) sits at (c*spacing, r*spacing, 0) with id 'vp_r_c'."""
    n = rows * cols
    unob = [[False] * n for _ in range(n)]
    for r in range(rows):
        for c in range(cols):
            for r2, c2 in ((r, c + 1), (r + 1, c)):
                if r2 < rows and c2 < cols:
                    unob[r * cols + c][r2 * cols + c2] = True
                    unob[r2 * cols + c2][r * cols + c] = True
    data = []
    for r in range(rows):
        for c in range(cols):
            pose = [0.0] * 16
            pose[3], pose[7] = c * spacing, r * spacing
            data.append({"image_id": f"vp_{r}_{c}", "pose": pose,
                         "included": True,
                         "unobstructed": unob[r * cols + c], "height": 1.5})
    tmpdir = Path(tmpdir)
    tmpdir.mkdir(parents=True, exist_ok=True)
    out = tmpdir / f"{scan}_connectivity.json"
    out.write_text(json.dumps(data))
    return out


def _instruction(rng: random.Random) -> str:
    """1-5 navigation sentences, ~30 words on average (R2R's length)."""
    def sentence():
        return (f"{rng.choice(_VERBS).capitalize()} {rng.choice(_DIRS)} "
                f"into the {rng.choice(_ROOMS)} and stop next to the "
                f"{rng.choice(_OBJECTS)} near the {rng.choice(_OBJECTS)}.")
    return " ".join(sentence() for _ in range(rng.randint(1, 5)))


# EQA's closed answer vocabulary (ANSWER_VOCAB): colors, counts, rooms
EQA_ANSWERS = ("red blue green white black brown yellow gray purple orange "
               "pink one two three four five").split() + _ROOMS
# FGR2R chunks cover at least this many steps: the JAX head reads every
# row's fg_view at the steps where the batch's first episode still walks
FG_STEPS = 15


def _fgr2r(instruction: str, n_steps: int):
    """FGR2R fields of one instruction: its sentences as the fine-grained
    chunks (word lists, as a Python-literal string) and the chunks' step
    spans, splitting steps 1..n_steps evenly."""
    chunks = [c.split() for c in instruction.split(". ") if c]
    cuts = np.linspace(1, n_steps + 1, len(chunks) + 1).round().astype(int)
    spans = [[int(a), int(max(b, a + 1))] for a, b in zip(cuts, cuts[1:])]
    return repr([chunks]), [spans]




# the synthetic object stores (data.feature_db.synthetic_object_db) hold
# at least this many objects per viewpoint where REVERIE and SOON episodes
# have their targets
MIN_OBJECTS = 3


def synthetic_object_id(scan: str, vp: str, k: int) -> str:
    """The k-th object id the synthetic object stores give (scan, vp)."""
    return _SyntheticObjectStore(n_objects=k + 1).get(f"{scan}_{vp}")[
        "obj_ids"][k]


def _object_annotations(root, graph, scan, rows, cols, n_episodes, seed,
                        split):
    """REVERIE (``REVERIE/annotations/<split>.json`` and the shared
    ``BBoxes.json``, merged across splits) and SOON
    (``SOON/annotations/<split>.jsonl``) episodes on the grid: a
    shortest path to a goal whose target is one of the synthetic objects
    there (the (path_id % MIN_OBJECTS)-th), visible also from the node
    before the goal (a second end viewpoint)."""
    rng = np.random.RandomState(seed + 2)
    trng = random.Random(seed + 2)
    bbox_file = root / "REVERIE" / "annotations" / "BBoxes.json"
    bbox_file.parent.mkdir(parents=True, exist_ok=True)
    bboxes = json.loads(bbox_file.read_text()) if bbox_file.exists() else {}
    reverie, soon = [], []
    for pid in range(n_episodes):
        a, b = rng.choice(rows * cols, 2, replace=False)
        path = graph.path(f"vp_{a // cols}_{a % cols}",
                          f"vp_{b // cols}_{b % cols}")
        ends = path[-2:] if len(path) > 2 else path[-1:]
        k = pid % MIN_OBJECTS
        obj, room = trng.choice(_OBJECTS), trng.choice(_ROOMS)
        goal_obj = synthetic_object_id(scan, path[-1], k)
        for vp in ends:
            bboxes.setdefault(f"{scan}_{vp}", {})[goal_obj] = {
                "visible_pos": [int(rng.randint(36))], "name": obj}
        reverie.append({"scan": scan, "path_id": pid, "objId": int(goal_obj),
                        "path": path, "heading": 0.0,
                        "instructions": [f"Go to the {room} and bring me "
                                         f"the {obj} by the "
                                         f"{trng.choice(_OBJECTS)}."]})
        heading = float(rng.rand() * 2 * math.pi)
        elevation = float(rng.rand() - 0.5)
        target = {"center": {"heading": heading, "elevation": elevation}}
        for corner, dh, de in (("left_top", -0.3, 0.2),
                               ("right_top", 0.3, 0.2),
                               ("right_bottom", 0.3, -0.2),
                               ("left_bottom", -0.3, -0.2)):
            target[corner] = {"heading": heading + dh,
                              "elevation": elevation + de}
        soon.append({"scan": scan, "path_id": pid, "path": path,
                     "bboxes": [{"image_id": vp, "pseudo_label": {
                         "obj_id": synthetic_object_id(scan, vp, k)},
                         "target": target} for vp in ends],
                     "instructions": [{"full": f"Find the {obj} in the "
                                               f"{room}, next to the "
                                               f"{trng.choice(_OBJECTS)}."}]})
    bbox_file.write_text(json.dumps(bboxes))
    (bbox_file.parent / f"{split}.json").write_text(json.dumps(reverie))
    soon_dir = root / "SOON" / "annotations"
    soon_dir.mkdir(parents=True, exist_ok=True)
    (soon_dir / f"{split}.jsonl").write_text(
        "".join(json.dumps(x) + "\n" for x in soon))


# CVDN dialogs: the words of each dialog cycle through these lengths (the
# dataset cuts a dialog's instruction to 128 words)
DIALOG_WORDS = (60, 90, 128, 150)
# ScanQA: frames per scene (the dataset draws at most 36 of them)
SCANQA_FRAMES = (40, 48)
# the augmented sets' fake token vocabulary: an instruction's word k has
# the id AUG_WORDS.index(word) + AUG_ID0 (the "bert ids" of its .jsonl)
AUG_WORDS = sorted(set((" ".join(_VERBS + _DIRS + _ROOMS + _OBJECTS)
                        + " into the and stop next to near").split()))
AUG_ID0 = 1000


def aug_encode(text: str):
    """A synthetic augmented instruction's token ids (aug_decoder's
    inverse on AUG_WORDS' words)."""
    return [AUG_WORDS.index(w) + AUG_ID0 for w in text.lower().split()]


def aug_decoder(ids) -> str:
    """The decoder the augmented datasets take in place of
    bert-base-uncased's (``R2RAugDataset.decoder``)."""
    return " ".join(AUG_WORDS[i - AUG_ID0] for i in ids)


# bert-base-uncased's first ids: [PAD], [unused0..98], the four specials,
# then [unused99..]
BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
BERT_REVISION = "86b5e0934494bd15c9632b12f734a8a67f723594"


def bert_vocab(words=AUG_WORDS):
    """A bert-base-uncased-shaped vocabulary (one token per line, the line
    number its id) with ``words`` from id AUG_ID0 on."""
    head = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    head += [f"[unused{i}]" for i in range(99, 99 + AUG_ID0 - len(head))]
    return head + list(words)


def write_bert_cache(home, words=AUG_WORDS, tokenizer_json: bool = False,
                     config: Dict[str, object] = None,
                     revision: str = BERT_REVISION) -> Path:
    """An offline Hugging Face cache under ``home`` (``$HF_HOME``) holding
    bert-base-uncased as a download leaves it: ``hub/models--bert-base-
    uncased/refs/main`` names ``revision``, whose snapshot has
    ``vocab.txt`` (``bert_vocab``), ``tokenizer_config.json`` (``config``)
    and ``config.json``, and with ``tokenizer_json`` also the fast
    tokenizer's ``tokenizer.json`` (WordPiece, BERT's normalizer and
    pre-tokenizer). Returns the hub directory (``$HF_HUB_CACHE``)."""
    hub = Path(home) / "hub"
    repo = hub / "models--bert-base-uncased"
    snap = repo / "snapshots" / revision
    snap.mkdir(parents=True, exist_ok=True)
    (repo / "refs").mkdir(exist_ok=True)
    (repo / "refs" / "main").write_text(revision)
    vocab = bert_vocab(words)
    (snap / "vocab.txt").write_text("".join(w + "\n" for w in vocab),
                                    encoding="utf-8")
    (snap / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "model_max_length": 512}
        if config is None else config))
    (snap / "config.json").write_text(json.dumps(
        {"architectures": ["BertForMaskedLM"], "model_type": "bert",
         "vocab_size": len(vocab)}))
    if tokenizer_json:
        (snap / "tokenizer.json").write_text(json.dumps({
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [
                {"id": vocab.index(t), "content": t, "single_word": False,
                 "lstrip": False, "rstrip": False, "normalized": False,
                 "special": True} for t in BERT_SPECIALS],
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": True,
                           "strip_accents": None, "lowercase": True},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": None,
            "decoder": {"type": "WordPiece", "prefix": "##",
                        "cleanup": True},
            "model": {"type": "WordPiece", "unk_token": "[UNK]",
                      "continuing_subword_prefix": "##",
                      "max_input_chars_per_word": 100,
                      "vocab": {w: i for i, w in enumerate(vocab)}}},
            ensure_ascii=False), encoding="utf-8")
    return hub


# ----------------------------------------------- sentencepiece models --- #
def _pb_varint(n: int) -> bytes:
    n &= (1 << 64) - 1          # negative int32s go out as 10 bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_field(num: int, value) -> bytes:
    """One field in the protobuf wire format: a bool or int as a varint, a
    float as fixed32, a str/bytes as a length-delimited field."""
    if isinstance(value, (bool, int)):
        return _pb_varint(num << 3) + _pb_varint(int(value))
    if isinstance(value, float):
        return _pb_varint(num << 3 | 5) + struct.pack("<f", value)
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _pb_varint(num << 3 | 2) + _pb_varint(len(value)) + value


def write_sentencepiece_model(path, pieces, model_type: int = 2) -> bytes:
    """Write ``pieces`` ((piece, score, type) or ``sentencepiece.Piece``) as
    a sentencepiece ``tokenizer.model`` in LLaMA's layout: a trainer spec
    of ``model_type`` (2 BPE, as LLaMA's; 1 Unigram) with byte fallback,
    unk/bos/eos ids 0-2 and pad id -1, and an
    identity normalizer, as protobuf serializes a ``ModelProto`` (fields
    in number order, defaults written out where LLaMA's file has them,
    and fields this package does not read: the trainer's input file,
    character coverage and sentence size, the self-test data). Returns the
    bytes."""
    out = bytearray()
    for p in pieces:
        piece, score, kind = (p.piece, p.score, p.type) \
            if hasattr(p, "piece") else p
        body = _pb_field(1, piece) + _pb_field(2, float(score))
        if kind != 1:
            body += _pb_field(3, kind)
        out += _pb_field(1, body)
    trainer = b"".join(_pb_field(n, v) for n, v in (
        (1, "corpus.txt"), (2, "tokenizer"), (3, model_type),
        (4, len(pieces)), (10, 0.99995), (11, 2000000),
        (20, 16), (35, True), (40, 0), (41, 1), (42, 2),
        (43, -1), (45, "<unk>"), (46, "<s>"), (47, "</s>"),
        (48, "<pad>")))
    normalizer = b"".join(_pb_field(n, v) for n, v in (
        (1, "identity"), (2, b""), (3, True), (4, False)))
    out += _pb_field(2, trainer) + _pb_field(3, normalizer)
    out += _pb_field(4, _pb_field(1, _pb_field(1, "hello") +
                                  _pb_field(2, "▁he llo")))
    data = bytes(out)
    Path(path).write_bytes(data)
    return data


# the characters of the seeded models' alphabet (one piece each); other
# characters go through the byte pieces
SPM_ALPHABET = "▁" + "".join(chr(c) for c in range(33, 127)) + "é"
SPM_MAX_PIECE = 16


def _spm_corpus() -> Dict[str, int]:
    """Word counts of the navigation prompts and the synthetic worlds'
    words, each word with sentencepiece's "▁" before it."""
    from .agents import prompts as P
    texts = [P.navigation_prompt(t, "Walk past the sofa and stop.", 4, 5,
                                 "") for t in ("r2r", "cvdn", "reverie",
                                               "soon", "eqa")]
    texts += [P.summarization_prompt(t, "", 3, 4)
              for t in ("r2r", "reverie", "soon")]
    texts.append(" ".join(_VERBS + _DIRS + _ROOMS + _OBJECTS + _VERBS
                          + _DIRS))
    counts: Dict[str, int] = {}
    for text in texts:
        for w in text.replace("<hist>", " ").replace("<cand>", " ").split():
            counts["▁" + w] = counts.get("▁" + w, 0) + 1
    return counts


def spm_pieces(n: int, seed: int = 0, user_defined=()) -> list:
    """A seeded LLaMA-layout piece list of exactly ``n`` pieces (``n`` >=
    259 + the alphabet + ``user_defined``): ``<unk>`` (UNKNOWN), ``<s>``,
    ``</s>`` (CONTROL), ``user_defined`` (USER_DEFINED), the 256 byte pieces
    ``<0x00>``..``<0xFF>``, then merged pieces at falling scores -- first
    those BPE training on ``_spm_corpus`` finds (the most frequent pair,
    the first in sorted order on a tie), then joins of two earlier pieces
    drawn from ``random.Random(seed)`` -- and last the alphabet's single
    characters, scored below every merge as in LLaMA's file."""
    from .models.sentencepiece import (BYTE, CONTROL, NORMAL, UNKNOWN,
                                       USER_DEFINED, Piece)
    head = [Piece("<unk>", 0.0, UNKNOWN), Piece("<s>", 0.0, CONTROL),
            Piece("</s>", 0.0, CONTROL)]
    head += [Piece(t, 0.0, USER_DEFINED) for t in user_defined]
    head += [Piece(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    n_merges = n - len(head) - len(SPM_ALPHABET)
    if n_merges < 0:
        raise ValueError(f"{n} pieces cannot hold the {len(head)} fixed "
                         f"ones and the {len(SPM_ALPHABET)}-character "
                         f"alphabet")
    known = set(SPM_ALPHABET)
    merged = []
    words = [(list(w), c) for w, c in sorted(_spm_corpus().items())]
    while len(merged) < n_merges:
        pairs: Dict[tuple, int] = {}
        for sym, c in words:
            for a, b in zip(sym, sym[1:]):
                pairs[a, b] = pairs.get((a, b), 0) + c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        new = best[0] + best[1]
        for sym, _ in words:
            i = 0
            while i < len(sym) - 1:
                if (sym[i], sym[i + 1]) == best:
                    sym[i:i + 2] = [new]
                i += 1
        if new not in known:
            known.add(new)
            merged.append(new)
    rng = random.Random(seed)
    pool = list(SPM_ALPHABET) + merged
    while len(merged) < n_merges:
        a, b = rng.choice(pool), rng.choice(pool)
        new = a + b
        if "▁" in b or len(new) > SPM_MAX_PIECE or new in known:
            continue
        known.add(new)
        merged.append(new)
        pool.append(new)
    body = [Piece(p, -float(k), NORMAL) for k, p in enumerate(merged)]
    tail = [Piece(c, -float(n_merges + k), NORMAL)
            for k, c in enumerate(SPM_ALPHABET)]
    return head + body + tail


# ------------------------------------------- LLaMA-3-layout directories --- #
LLAMA3_BOS, LLAMA3_EOS = "<|begin_of_text|>", "<|end_of_text|>"
# the BPE entries of Meta-Llama-3-8B's tokenizer.json (its special tokens
# follow at 128000-128255)
LLAMA3_VOCAB = 128000
LLAMA3_MAX_PIECE = 16
# Meta-Llama-3-8B's config.json (its Hugging Face repository's)
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.40.0.dev0", "use_cache": True,
    "vocab_size": 128256}


def llama3_specials() -> list:
    """LLaMA-3's 256 special tokens in id order."""
    head = [LLAMA3_BOS, LLAMA3_EOS]
    head += [f"<|reserved_special_token_{i}|>" for i in range(4)]
    head += ["<|start_header_id|>", "<|end_header_id|>",
             "<|reserved_special_token_4|>", "<|eot_id|>"]
    return head + [f"<|reserved_special_token_{i}|>"
                   for i in range(5, 256 - 5)]


def llama3_tokenizer_config(first_id: int) -> dict:
    """LLaMA-3's tokenizer_config.json, its special tokens at ``first_id``
    on (a PreTrainedTokenizerFast with no unk or pad token)."""
    added = {str(first_id + k): {
        "content": t, "lstrip": False, "normalized": False, "rstrip": False,
        "single_word": False, "special": True}
        for k, t in enumerate(llama3_specials())}
    return {"added_tokens_decoder": added, "bos_token": LLAMA3_BOS,
            "clean_up_tokenization_spaces": True, "eos_token": LLAMA3_EOS,
            "model_input_names": ["input_ids", "attention_mask"],
            "model_max_length": 1000000000000000019884624838656,
            "tokenizer_class": "PreTrainedTokenizerFast"}


def llama3_tokenizer_spec(base: dict, n_vocab: int = LLAMA3_VOCAB,
                          seed: int = 0) -> dict:
    """``base`` (a LLaMA-3-layout ``tokenizer.json`` as a dict, such as
    tests/fixtures/llama3_bpe's, its special tokens right after its
    vocabulary) grown to exactly ``n_vocab`` BPE entries: after its trained
    merges, joins of two earlier entries of at most LLAMA3_MAX_PIECE / 2
    characters drawn from ``random.Random(seed)`` (the second not starting
    a word, the join not known), each with its merge. The special tokens move to
    ``n_vocab`` on, the post-processor's ``<|begin_of_text|>`` with them."""
    spec = json.loads(json.dumps(base))
    model = spec["model"]
    vocab = dict(model["vocab"])
    if len(vocab) > n_vocab:
        raise ValueError(f"{len(vocab)} entries do not fit in {n_vocab}")
    merges = [list(m.split(" ", 1)) if isinstance(m, str) else list(m)
              for m in model["merges"]]
    half = LLAMA3_MAX_PIECE // 2
    pool = [t for t in sorted(vocab, key=vocab.get) if len(t) <= half]
    rng = random.Random(seed)
    while len(vocab) < n_vocab:
        a, b = rng.choice(pool), rng.choice(pool)
        new = a + b
        if b.startswith("\u0120") or new in vocab:
            continue
        vocab[new] = len(vocab)
        merges.append([a, b])
        if len(new) <= half:
            pool.append(new)
    model["vocab"], model["merges"] = vocab, merges
    moved = {}
    for k, t in enumerate(spec["added_tokens"]):
        t["id"] = moved[t["content"]] = n_vocab + k

    def renumber(proc):
        if proc is None:
            return
        for p in proc.get("processors", []):
            renumber(p)
        for name, st in (proc.get("special_tokens") or {}).items():
            st["ids"] = [moved.get(t, i) for t, i in zip(st["tokens"],
                                                          st["ids"])]
    renumber(spec.get("post_processor"))
    return spec


def write_llama3_checkpoint(path, base: dict):
    """A Meta-Llama-3-8B-shaped checkpoint directory without weights (for
    --from_scratch): ``config.json`` (LLAMA3_8B_CONFIG), ``tokenizer.json``
    (``llama3_tokenizer_spec(base)``) and ``tokenizer_config.json``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(LLAMA3_8B_CONFIG, indent=2))
    (path / "tokenizer.json").write_text(json.dumps(
        llama3_tokenizer_spec(base), ensure_ascii=False), encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps(
        llama3_tokenizer_config(LLAMA3_VOCAB), indent=2))


def _plain_instruction(rng: random.Random) -> str:
    """An _instruction in AUG_WORDS' words (no capitals, no stops)."""
    return " ".join(f"{rng.choice(_VERBS)} {rng.choice(_DIRS)} into the "
                    f"{rng.choice(_ROOMS)} and stop next to the "
                    f"{rng.choice(_OBJECTS)}" for _ in range(rng.randint(1, 3)))


def _dialog(rng: random.Random, n_words: int):
    """A navigator/oracle dialog of about n_words words: questions end
    with "?", answers without a stop (the dataset adds one)."""
    turns, words = [], 0
    while words < n_words:
        role = "navigator" if len(turns) % 2 == 0 else "oracle"
        if role == "navigator":
            msg = (f"should I {rng.choice(_VERBS)} {rng.choice(_DIRS)} past "
                   f"the {rng.choice(_OBJECTS)}?")
        else:
            msg = (f"{rng.choice(_VERBS)} {rng.choice(_DIRS)} into the "
                   f"{rng.choice(_ROOMS)} and look for the "
                   f"{rng.choice(_OBJECTS)} near the {rng.choice(_OBJECTS)}")
        turns.append({"role": role, "message": msg})
        words += len(msg.split()) + 1
    return turns


def _dialog_annotations(root, graph, scan, rows, cols, n_episodes, seed,
                        split):
    """CVDN episodes (``CVDN/annotations/<split>.json``): a dialog of
    DIALOG_WORDS[i % 4] words, the start panorama and its heading, the
    planner's path to a goal and the goal's end panoramas (it and one
    neighbour). Every third planner path walks one node past the goal,
    so trusted_path corrects it."""
    rng = np.random.RandomState(seed + 3)
    trng = random.Random(seed + 3)
    items = []
    for i in range(n_episodes):
        a, b = rng.choice(rows * cols, 2, replace=False)
        start, goal = f"vp_{a // cols}_{a % cols}", f"vp_{b // cols}_{b % cols}"
        path = graph.path(start, goal)
        nbrs = [v for v in sorted(graph.neighbors(goal)) if v not in path]
        planner = path + nbrs[-1:] if i % 3 == 2 else path
        ends = [goal] + [v for v in nbrs if v not in planner][:1]
        items.append({"inst_idx": 100 + i, "scan": scan,
                      "target": trng.choice(_OBJECTS),
                      "dialog_history": _dialog(
                          trng, DIALOG_WORDS[i % len(DIALOG_WORDS)]),
                      "start_pano": {"pano": start,
                                     "heading": float(rng.rand() * 2
                                                      * math.pi)},
                      "planner_path": planner, "end_panos": ends})
    out = root / "CVDN" / "annotations" / f"{split}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(items))


def _qa_annotations(root, n_episodes, seed, split):
    """ScanQA scenes (``ScanQA/annotations/<split>.json``: SCANQA_FRAMES
    frames each, two questions per scene) and LLaVA conversations
    (``LLaVA/annotations/<split>.json``), n_episodes questions each."""
    trng = random.Random(seed + 4)
    scenes = []
    for i in range(-(-n_episodes // 2)):
        n_frames = SCANQA_FRAMES[i % len(SCANQA_FRAMES)]
        scenes.append({
            "scene_id": f"scene{i:04d}_00",
            "image_info": [{"image_id": f"frame_{k}"}
                           for k in range(n_frames)],
            "annotation": [{
                "question_id": f"q{2 * i + j}",
                "question": f"what is next to the {trng.choice(_OBJECTS)} "
                            f"in the {trng.choice(_ROOMS)}?",
                "answers": [trng.choice(EQA_ANSWERS).capitalize(),
                            trng.choice(EQA_ANSWERS)]}
                for j in range(min(2, n_episodes - 2 * i))]})
    llava = [{"id": f"{i:04d}", "image": f"{100000 + i:012d}.jpg",
              "conversations": [
                  {"from": "human", "value": f"<image>\nDescribe the "
                                             f"{trng.choice(_ROOMS)}."},
                  {"from": "gpt", "value": f"A {trng.choice(EQA_ANSWERS)} "
                                           f"{trng.choice(_OBJECTS)} near a "
                                           f"{trng.choice(_OBJECTS)}."}]}
             for i in range(n_episodes)]
    for task, data in (("ScanQA", scenes), ("LLaVA", llava)):
        out = root / task / "annotations" / f"{split}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(data))


def _aug_annotations(root, graph, scan, rows, cols, n_episodes, seed,
                     split):
    """The augmented sets, both ways: ``.jsonl`` files of token ids
    (aug_encode) with their own paths (R2R/annotations/<split>_aug.jsonl;
    REVERIE/annotations/<split>_aug.jsonl, whose pos_vps are the goal and
    the node before it) and ``.json`` files in R2R's and REVERIE's layout
    (<split>_aug.json: the split's R2R and REVERIE episodes again under
    path ids offset by 1000)."""
    rng = np.random.RandomState(seed + 5)
    trng = random.Random(seed + 5)
    r2r, rev = [], []
    for i in range(n_episodes):
        a, b = rng.choice(rows * cols, 2, replace=False)
        path = graph.path(f"vp_{a // cols}_{a % cols}",
                          f"vp_{b // cols}_{b % cols}")
        r2r.append({"instr_id": f"{i}_0", "scan": scan, "path": path,
                    "heading": float(rng.rand() * 2 * math.pi),
                    "instr_encoding": aug_encode(_plain_instruction(trng))})
        rev.append({"instr_id": f"{i}_{i % 3}", "scan": scan, "path": path,
                    "instr_encoding": aug_encode(_plain_instruction(trng)),
                    "pos_vps": path[-2:]})
    for task, data in (("R2R", r2r), ("REVERIE", rev)):
        d = root / task / "annotations"
        (d / f"{split}_aug.jsonl").write_text(
            "".join(json.dumps(x) + "\n" for x in data))
        items = json.loads((d / f"{split}.json").read_text())
        for x in items:
            x["path_id"] += 1000
        (d / f"{split}_aug.json").write_text(json.dumps(items))


def make_r2r_world(root, n_episodes: int = 32, rows: int = 8, cols: int = 8,
                   scan: str = "grid0", seed: int = 0, split: str = "val"
                   ) -> Path:
    """Write ``root/connectivity`` and R2R annotations (``<split>.json``)
    for shortest-path episodes between random distinct grid nodes, each
    with FGR2R chunks (``new_instructions``, ``chunk_view``); beside them
    EQA annotations of as many episodes (``EQA/annotations/<split>.json``:
    a question about the goal, an answer of ``answer_vocab.json``, which
    holds EQA_ANSWERS), and as many REVERIE and SOON episodes
    (_object_annotations), CVDN dialogs (_dialog_annotations), ScanQA
    questions and LLaVA conversations (_qa_annotations) and augmented R2R
    and REVERIE episodes (_aug_annotations). Returns the R2R annotation
    file."""
    root = Path(root)
    make_grid_connectivity(root / "connectivity", scan=scan, rows=rows,
                           cols=cols)
    graph = ScanGraph.from_connectivity(str(root / "connectivity"), scan)
    rng = np.random.RandomState(seed)
    irng = random.Random(seed)
    items = []
    for pid in range(n_episodes):
        start = end = (0, 0)
        while start == end:
            start, end = tuple(rng.randint(0, rows, 2)), \
                tuple(rng.randint(0, cols, 2))
        path = graph.path(f"vp_{start[0]}_{start[1]}",
                          f"vp_{end[0]}_{end[1]}")
        instruction = _instruction(irng)
        fg, chunk_view = _fgr2r(instruction, max(len(path) - 1, FG_STEPS))
        items.append({"distance": 1.0, "scan": scan, "path_id": pid,
                      "heading": 0.0, "instructions": [instruction],
                      "path": path, "new_instructions": fg,
                      "chunk_view": chunk_view})
    anno = root / "R2R" / "annotations" / f"{split}.json"
    anno.parent.mkdir(parents=True, exist_ok=True)
    anno.write_text(json.dumps(items))

    qrng = random.Random(seed + 1)
    eqa = []
    for i in range(n_episodes):
        start, end = qrng.sample(range(rows * cols), 2)
        eqa.append({"sample_idx": i, "scan": scan, "path": graph.path(
            f"vp_{start // cols}_{start % cols}",
            f"vp_{end // cols}_{end % cols}"), "question": {
            "question_text": f"what color is the {qrng.choice(_OBJECTS)} in "
                             f"the {qrng.choice(_ROOMS)}?",
            "answer_text": qrng.choice(EQA_ANSWERS)}})
    eqa_dir = root / "EQA" / "annotations"
    eqa_dir.mkdir(parents=True, exist_ok=True)
    (eqa_dir / f"{split}.json").write_text(json.dumps(eqa))
    (eqa_dir / "answer_vocab.json").write_text(json.dumps(EQA_ANSWERS))
    _object_annotations(root, graph, scan, rows, cols, n_episodes, seed,
                        split)
    _dialog_annotations(root, graph, scan, rows, cols, n_episodes, seed,
                        split)
    _qa_annotations(root, n_episodes, seed, split)
    _aug_annotations(root, graph, scan, rows, cols, n_episodes, seed, split)
    return anno


def eval_config(max_action_len: int, name: str = "R2R"):
    """The slice of the experiment config validate_streaming reads."""
    return SimpleNamespace(
        Optim=SimpleNamespace(val_max_action_len={name: max_action_len}))


def r2r_eval(anno_file, runner, n_slots: int, image_feat_size: int,
             seed: int = 0, prefix_cache: bool = False):
    """(agent, dataset, args) for greedy R2R streaming evaluation over a
    world written by make_r2r_world, with synthetic image features. The
    prompts go through the runner's tokenizer (``NavTokenizer()`` for
    bytes, ``NavTokenizer.bpe()`` for subwords); ``prefix_cache`` asks for
    the prefix-cached eval step."""
    from .agents.mp3d_agent import EvalArgs, R2RAgent
    from .data.r2r import R2RDataset

    world = WorldModel(str(Path(anno_file).parents[2] / "connectivity"))
    ds = R2RDataset(anno_file, world)
    ds.init_feat_db(SyntheticImageFeaturesDB(image_feat_size))
    args = EvalArgs(seed=seed, val_batch_size=n_slots,
                    image_feat_size=image_feat_size,
                    prefix_cache=prefix_cache)
    return R2RAgent(args, world, runner), ds, args


def eqa_eval(root, split, runner, n_slots: int, image_feat_size: int,
             seed: int = 0, prefix_cache: bool = False):
    """(agent, dataset, args) for EQA streaming evaluation over the EQA
    annotations make_r2r_world wrote beside ``split``'s R2R ones."""
    from .agents.mp3d_agent import EQAAgent, EvalArgs
    from .data.eqa import EQADataset

    eqa_dir = Path(root) / "EQA" / "annotations"
    world = WorldModel(str(Path(root) / "connectivity"))
    ds = EQADataset(eqa_dir / f"{split}.json", world, answer_vocab=json.loads(
        (eqa_dir / "answer_vocab.json").read_text()))
    ds.init_feat_db(SyntheticImageFeaturesDB(image_feat_size))
    args = EvalArgs(seed=seed, val_batch_size=n_slots,
                    image_feat_size=image_feat_size,
                    prefix_cache=prefix_cache)
    return EQAAgent(args, world, runner), ds, args


def object_eval(task, root, split, runner, n_slots: int,
                image_feat_size: int, obj_db, seed: int = 0,
                prefix_cache: bool = False, **flags):
    """(agent, dataset, args) for REVERIE or SOON (``task``) streaming
    evaluation with object grounding (enable_og) over the annotations
    make_r2r_world wrote beside ``split``'s R2R ones, with synthetic image
    features and the object DB ``obj_db``; ``flags`` go to the args
    (do_sample, temperature)."""
    from .agents.mp3d_agent import EvalArgs, REVERIEAgent, SOONAgent
    from .data.reverie import REVERIEDataset
    from .data.soon import SOONDataset

    world = WorldModel(str(Path(root) / "connectivity"))
    if task == "REVERIE":
        anno = Path(root) / "REVERIE" / "annotations"
        ds = REVERIEDataset(anno / f"{split}.json", world,
                            bbox_file=anno / "BBoxes.json", split=split)
        agent_cls = REVERIEAgent
    else:
        ds = SOONDataset(Path(root) / "SOON" / "annotations"
                         / f"{split}.jsonl", world, split=split)
        agent_cls = SOONAgent
    ds.init_feat_db(SyntheticImageFeaturesDB(image_feat_size), obj_db)
    args = EvalArgs(seed=seed, val_batch_size=n_slots,
                    image_feat_size=image_feat_size,
                    obj_feat_size=obj_db.obj_feat_size, enable_og=True,
                    prefix_cache=prefix_cache, **flags)
    return agent_cls(args, world, runner), ds, args


def reverie_eval(root, split, runner, n_slots, image_feat_size, obj_db,
                 **kw):
    """object_eval for REVERIE (obj_db in the REVERIE layout)."""
    return object_eval("REVERIE", root, split, runner, n_slots,
                       image_feat_size, obj_db, **kw)


def soon_eval(root, split, runner, n_slots, image_feat_size, obj_db, **kw):
    """object_eval for SOON (obj_db in the SOON layout)."""
    return object_eval("SOON", root, split, runner, n_slots,
                       image_feat_size, obj_db, **kw)


def feature_dbs(image_feat_size: int) -> Dict[str, SyntheticImageFeaturesDB]:
    """Synthetic stores under configs/multi.yaml's feature_database keys:
    36 views per viewpoint (mp3d), one frame per ScanNet frame (scan_qa,
    keyed scene_frame) and per COCO image (coco)."""
    return {"mp3d": SyntheticImageFeaturesDB(image_feat_size),
            "scan_qa": SyntheticImageFeaturesDB(image_feat_size, num_views=1),
            "coco": SyntheticImageFeaturesDB(image_feat_size, num_views=1)}


def world_features(connectivity_dir, image_feat_size: int):
    """(key, [36, image_feat_size] f32) for every viewpoint of every scan
    under ``connectivity_dir``: SyntheticImageFeaturesDB's values, keyed
    ``<scan>_<viewpoint>``."""
    synth = SyntheticImageFeaturesDB(image_feat_size)
    for conn in sorted(Path(connectivity_dir).glob("*_connectivity.json")):
        scan = conn.name[: -len("_connectivity.json")]
        for node in json.loads(conn.read_text()):
            vp = node["image_id"]
            yield f"{scan}_{vp}", synth.get_image_feature(scan, vp)


def write_npy_features(root, connectivity_dir, image_feat_size: int) -> Path:
    """One ``<scan>_<viewpoint>.npy`` file of [36, image_feat_size] f32
    features (SyntheticImageFeaturesDB's values) per viewpoint of every scan
    under ``connectivity_dir``. Returns ``root``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for key, feats in world_features(connectivity_dir, image_feat_size):
        np.save(root / f"{key}.npy", feats)
    return root


def write_hdf5_features(path, connectivity_dir, image_feat_size: int
                        ) -> Path:
    """The HDF5 twin of write_npy_features: one gzip'd [36,
    image_feat_size] f32 dataset per viewpoint, SyntheticImageFeaturesDB's
    values, written as the extractors write theirs
    (``vision.extract.write_features``). Returns ``path``."""
    from .utils import hdf5
    from .vision.extract import write_features
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with hdf5.File(path, "w") as f:
        for key, feats in world_features(connectivity_dir, image_feat_size):
            write_features(f, key, feats)
    return path


class _NpyFiles:
    """An HDF5 file's ``[key]`` read over a directory of .npy files."""

    def __init__(self, root):
        self.root = Path(root)

    def __getitem__(self, key: str) -> np.ndarray:
        return np.load(self.root / f"{key}.npy")


class NpyFeaturesDB(ImageFeaturesDB):
    """ImageFeaturesDB over write_npy_features' directory: the same reads,
    slicing and ``_store`` cache (``cache=False``, as create_feature_db
    builds it: only a prefetcher fills ``_store``). Counts the reads made
    on the main thread (the rollouts' get_obs; a prefetcher reads on its
    workers) in ``reads``, and those that found their key in ``_store`` in
    ``hits``."""

    def __init__(self, root, image_feat_size: int):
        super().__init__(str(root), image_feat_size)
        self.reads = self.hits = 0

    def _file(self):
        return _NpyFiles(self.img_ft_file)

    def get_image_feature(self, scan, viewpoint=None):
        if threading.current_thread() is threading.main_thread():
            key = f"{scan}_{viewpoint}" if viewpoint is not None else scan
            self.reads += 1
            self.hits += key in self._store
        return super().get_image_feature(scan, viewpoint)


class _NoPrefetch:
    """Takes an agent's FeaturePrefetcher's place and fetches nothing."""

    def prefetch_candidates(self, obs):
        pass

    def drain(self):
        pass


def hold_off_prefetch(agent):
    """Keep ``agent`` from prefetching: its rollouts build a prefetcher only
    where the agent has none."""
    agent._prefetcher = _NoPrefetch()
    return agent


def cvdn_eval(root, split, runner, n_slots: int, image_feat_size: int,
              seed: int = 0, prefix_cache: bool = False):
    """(agent, dataset, args) for greedy CVDN streaming evaluation over the
    dialogs make_r2r_world wrote beside ``split``'s R2R episodes."""
    from .agents.mp3d_agent import CVDNAgent, EvalArgs
    from .data.cvdn import CVDNDataset

    world = WorldModel(str(Path(root) / "connectivity"))
    ds = CVDNDataset(Path(root) / "CVDN" / "annotations" / f"{split}.json",
                     world, split=split)
    ds.init_feat_db(SyntheticImageFeaturesDB(image_feat_size))
    args = EvalArgs(seed=seed, val_batch_size=n_slots,
                    image_feat_size=image_feat_size,
                    prefix_cache=prefix_cache)
    return CVDNAgent(args, world, runner), ds, args


def scanqa_eval(root, split, runner, n_slots: int, image_feat_size: int,
                seed: int = 0):
    """(agent, dataset, args) for ScanQA evaluation (ScanQAAgent.validate)
    over the questions make_r2r_world wrote, with a synthetic scan_qa
    frame store."""
    from .agents.llava_agent import ScanQAAgent
    from .agents.mp3d_agent import EvalArgs
    from .data.scanqa import ScanQADataset

    ds = ScanQADataset(Path(root) / "ScanQA" / "annotations"
                       / f"{split}.json", split=split)
    ds.init_feat_db(feature_dbs(image_feat_size)["scan_qa"])
    args = EvalArgs(seed=seed, val_batch_size=n_slots,
                    image_feat_size=image_feat_size)
    return ScanQAAgent(args, None, runner), ds, args


def train_config(max_action_len: int, name: str = "R2R"):
    """The slice of the experiment config teacher-forcing training reads
    (both stages list the one task with no loss coefficient)."""
    stage = SimpleNamespace(SOURCE=[name], LOSS_COEF={})
    return SimpleNamespace(
        Optim=SimpleNamespace(train_max_action_len={name: max_action_len},
                              val_max_action_len={name: max_action_len}),
        Pretrain=stage, Multi=stage)


def r2r_train(anno_file, runner, args, batch_size: int, shuffle: bool = True):
    """(agent, dataset, loader) for teacher-forcing training over a world
    written by make_r2r_world(split="train"), with synthetic image
    features; ``args`` is an agents.mp3d_agent.TrainArgs."""
    from .agents.mp3d_agent import R2RAgent
    from .data.r2r import R2RDataset

    world = WorldModel(str(Path(anno_file).parents[2] / "connectivity"))
    ds = R2RDataset(anno_file, world, training=True)
    ds.init_feat_db(SyntheticImageFeaturesDB(args.image_feat_size))
    loader = Dataloader(ds, batch_size, shuffle=shuffle, seed=args.seed)
    return R2RAgent(args, world, runner), ds, loader


# The attention kernels (forward O, dK/dV, dQ) against their plain versions,
# element by element: tol = ATTN_REL * |ref| + ATTN_ROW * rms(ref's row of
# D) + ATTN_FLOOR. Both sides round their output to bf16 once (up to one
# bf16 ulp apart, at most 2**-7 of the element) and round P or dS to bf16
# before a product, which adds noise of ~2**-9 of the row's scale. The
# absolute floor is for outputs the plain version makes exactly 0 (a row
# that sees one key has dS = 0), where the kernel's f32 dP - delta leaves
# ~1e-7. A kernel that skips one key of a row that sees 256 keys or more
# moves that row by several times ATTN_ROW of its RMS.
ATTN_REL = 2 ** -6
ATTN_ROW = 2 ** -5
ATTN_FLOOR = 1e-5


def visible_keys(mask, t: int, causal: bool):
    """[B, T]: how many valid keys each query row sees under a [B, S] key
    mask (and, under causal, the diagonal)."""
    s = mask.shape[1]
    keys = mask[:, None, :].expand(-1, t, -1)
    if causal:
        keys = keys & mask.new_ones((t, s)).tril(s - t)
    return keys.sum(-1)


def attn_excess(got, want, rows) -> float:
    """The worst |got - want| / tol (ATTN_* above) over ``rows`` ([B, L]
    bool) of two [B, L, H, D] tensors: at most 1 passes."""
    w = want.float()[rows]
    d = (got.float()[rows] - w).abs()
    if not w.numel():
        return 0.0
    rms = w.square().mean(-1, keepdim=True).sqrt()
    tol = ATTN_REL * w.abs() + ATTN_ROW * rms + ATTN_FLOOR
    return (d / tol).max().item()


# Gradient parity against the JAX package, element by element:
#   |got - want| <= atol + rtol * max(|want|, GRAD_ROW_C * rms(want's row))
# where a row is the leaf's last axis (a vector leaf is one row, a scalar
# its own row). The f32 error of a sum scales with the size of its terms,
# not of its result: an element that cancels down to a small fraction of
# its row carries the rounding of terms the size of the row's large
# elements, and two correct implementations that sum in other orders (XLA
# and ATen, or one library on two instruction sets) part there by more
# than rtol of the element itself. The row's RMS stands in for the size
# of those terms. GRAD_ROW_C = 1e-2, the reason: across the port's
# parity tests under eight instruction-set settings of XLA and ATen
# (scripts/parity_sweep.sh, scripts/parity_isa_probe.py), the worst
# element needed 2.79e-3 (a fused DAgger OG batch's llm.embed element of
# 0.055, 2.6e-4 off in a row of RMS 43, under XLA's SSE4_2 with ATen's
# default), and the JAX package against itself, SSE4_2 against default
# XLA on the same weights, needed 8.5e-3 (an element of 0.021, 6.4e-5
# off in a row of RMS 2.56): a rule the reference fails against itself
# is too tight. At 1e-2 the worst |got - want| / bound the sweep saw is
# 0.63 for the port against JAX and 0.89 for JAX against itself. The
# planted faults of tests/test_torch_parity_rules.py (a leaf scaled by
# 1.01, a row zeroed, a sign flipped, another batch's leaf, one element
# moved) fail it by 5x to 3700x.
GRAD_ROW_C = 1e-2


def grad_bound(want, rtol: float, atol: float):
    """The per-element bound on |got - want| (see GRAD_ROW_C above)."""
    w = np.abs(np.asarray(want, np.float64))
    rows = w.reshape(-1, w.shape[-1]) if w.ndim else w.reshape(1, 1)
    rms = np.sqrt(np.mean(np.square(rows), -1, keepdims=True))
    return (atol + rtol * np.maximum(rows, GRAD_ROW_C * rms)).reshape(w.shape)


def grad_ratio(got, want, rtol: float, atol: float):
    """|got - want| / grad_bound per element, as float64: at most 1
    passes. 0 where the two are equal (NaN against NaN included), inf
    where a NaN meets a number."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.abs(g - w) / grad_bound(w, rtol, atol)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    return np.where(same, 0.0, np.nan_to_num(ratio, nan=np.inf))


def assert_grads_close(got, want, rtol: float, atol: float, *,
                       err_msg: str = ""):
    """Hold the port's gradient ``got`` to JAX's ``want`` under
    grad_bound: two arrays, or two dicts of leaves by name (every leaf of
    ``want``; ``got`` must hold each). On failure, names the leaf, the
    count of elements over the bound and the worst one."""
    if not isinstance(want, dict):
        got, want = {err_msg: got}, {err_msg: want}
    for name, w in want.items():
        assert name in got, f"{err_msg} {name}: no such gradient leaf"
        ratio = grad_ratio(got[name], w, rtol, atol)
        if not ratio.size or ratio.max() <= 1.0:
            continue
        g, w = np.asarray(got[name]), np.asarray(w, np.float64)
        i = np.unravel_index(np.argmax(ratio), ratio.shape)
        row = w[i[:-1]] if w.ndim else w
        raise AssertionError(
            f"{err_msg} {name}: {int((ratio > 1).sum())} of {w.size} "
            f"elements over atol {atol} + rtol {rtol} * max(|want|, "
            f"{GRAD_ROW_C} * row RMS); worst at "
            f"{tuple(int(k) for k in i)}: got {g[i]!r}, want {w[i]!r}, "
            f"{ratio[i]:.3g} x its bound {grad_bound(w, rtol, atol)[i]!r}, "
            f"row RMS {np.sqrt(np.mean(np.square(row))):.6g}")


# int8 K/V codes (kv_quantize: round(x / s), s = amax / 127 per token and
# head) quantized from two packages' own K/V, which differ by float
# rounding (other summation orders, ~1e-6 relative): an element whose
# x / s sits within KV_BOUNDARY of a .5 boundary of its grid may land one
# code apart; any other element must give the same code. A 1e-6 relative
# move of x and of s shifts x / s by at most ~2.6e-4 (|x / s| <= 127).
KV_BOUNDARY = 1e-3


def assert_codes_near(q, sc, src, jq, jsc):
    """q, sc: int8 codes and f32 scales of the K/V ``src`` (numpy, the
    port's); jq, jsc: the reference's codes and scales of its own K/V.
    Scales agree to rtol 2e-6; codes are equal except one code apart at
    elements within KV_BOUNDARY of a rounding boundary."""
    sc, jsc = np.asarray(sc), np.asarray(jsc)
    np.testing.assert_allclose(sc, jsc, rtol=2e-6, atol=0)
    ratio = np.abs(np.asarray(src) / np.where(sc > 0, sc, 1.0))
    boundary = np.abs(ratio - np.floor(ratio) - 0.5) < KV_BOUNDARY
    diff = np.asarray(q, np.int32) - np.asarray(jq, np.int32)
    assert np.abs(diff).max() <= 1
    assert not diff[~boundary].any(), np.argwhere(diff & ~boundary)


def synthetic_nav_batch(cfg, b: int = 2, g: int = 12, v: int = 8, c: int = 8,
                        hh: int = 4, tlen: int = 64, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
    """Random but structurally consistent navigation batch (the layout of
    navillm_tpu.testing.synthetic_nav_batch): slots 0..5 valid, slot 1
    visited, local views 1..3 map to slots 2..4."""
    r = np.random.RandomState(seed)
    h = cfg.hidden_size
    n_nodes = min(6, g)
    gmask = np.zeros((b, g), bool)
    gmask[:, :n_nodes] = True
    visited = np.zeros((b, g), bool)
    visited[:, 1] = True
    match = np.full((b, v), -1, np.int32)
    for j, s in ((1, 2), (2, 3), (3, 4)):
        if j < v and s < n_nodes:
            match[:, j] = s
    pano_m = np.zeros((b, v), bool)
    pano_m[:, : min(5, v)] = True
    cand_slots = [s for s in range(2, n_nodes) if not visited[0, s]][:c]
    order = np.full((b, c), -1, np.int32)
    cand_pos = np.full((b, c), -1, np.int32)
    for bi in range(b):
        perm = r.permutation(cand_slots)
        order[bi, : len(perm)] = perm
        cand_pos[bi, : len(perm)] = 8 + 2 * np.arange(len(perm))
    hist_pos = np.full((b, hh), -1, np.int32)
    hist_pos[:, 0] = 4
    return {
        "gmap_img_embeds": r.randn(b, g, h).astype(np.float32),
        "gmap_step_ids": r.randint(0, 5, (b, g)).astype(np.int32),
        "gmap_pos_fts": r.randn(b, g, cfg.angle_feat_size + 3)
        .astype(np.float32),
        "gmap_masks": gmask,
        "gmap_visited_masks": visited,
        "vp_img_embeds": r.randn(b, v, h).astype(np.float32),
        "vp_pos_fts": r.randn(b, v, 2 * cfg.angle_feat_size + 6)
        .astype(np.float32),
        "pano_masks": pano_m,
        "local_match_slot": match,
        "cand_order": order,
        "cand_positions": cand_pos,
        "hist_positions": hist_pos,
        "hist_embeds": r.randn(b, hh, h).astype(np.float32),
        "input_ids": r.randint(3, cfg.llm.vocab_size - 1, (b, tlen))
        .astype(np.int32),
        "attention_mask": np.ones((b, tlen), bool),
        "cls_pos": np.full((b,), tlen - 1, np.int32),
    }


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _gloo_entry(rank, nprocs, port, fn, out_dir, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=nprocs)
    try:
        result = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def spawn_gloo(fn, nprocs: int, *args):
    """[fn(rank, *args) for each rank] from ``nprocs`` spawned processes
    joined by a gloo process group over localhost (one thread each).
    ``fn`` must be importable by name (a module-level function) and its
    result picklable by torch.save; a rank's exception is raised here."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_gloo_entry, args=(nprocs, free_port(), fn, out,
                                              args),
                           nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(Path(out) / f"rank{r}.pt", weights_only=False)
                for r in range(nprocs)]
