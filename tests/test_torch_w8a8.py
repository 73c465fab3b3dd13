"""W8A8 on int8 weights, the w4a8 generation path, quantized random init
and f32 x into the int4 matmul: the port vs the JAX package.

- ``_act_q`` and ``_mm`` with a8 on int8 weights are held exactly: an
  int8 x int8 -> int32 product (exact on both sides), then the same f32
  rescale in the same order and one cast.
- ``generate`` on a w4a8 tree (int4 layers, int8 embed and lm_head, int8
  activations: the lm_head product is W8A8) and on a W8A8 tree gives JAX's
  tokens, with and without an int8 prompt K/V. Before the port took W8A8
  on int8 weights, the w4a8 tree raised at its first lm_head product.
- Streaming evaluation at the JAX bench's 7B headline configuration (int8
  weights, int8 activations, prefix cache, int8 K/V) and on a w4a8 tree,
  mirroring tests/test_kv8.py: every episode is covered, the port's
  trajectories equal JAX's under the same configuration, and at least 80%
  equal the weight-only bf16-cache run's (JAX's own contract: two int8
  noise sources are stacked).
- ``init_params_quantized`` equals ``quantize_llama_params`` of
  ``init_llama_params`` drawn from a generator in the same state, bit for
  bit (jax.random cannot be replayed, so this is the port's own check).
- ``matmul_q4`` on CPU tensors with f32 x against the Pallas kernel in
  interpret mode, within its own test's bound (1e-5 of max(|ref|, 1)).
(``int_mm``'s padding on the card: tests/test_torch_kernels.py.)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import load_agent  # noqa: E402
from navillm_tpu.agents.runner import NavModelRunner as JRunner  # noqa: E402
from navillm_tpu.agents.runner import RolloutDims as JDims  # noqa: E402
from navillm_tpu.data.datasets import load_dataset  # noqa: E402
from navillm_tpu.data.feature_db import SyntheticImageFeaturesDB  # noqa: E402
from navillm_tpu.data.loaders import Dataloader  # noqa: E402
from navillm_tpu.models import llama as JL  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models import quant as JQ  # noqa: E402
from navillm_tpu.models.decoding import generate as j_generate  # noqa: E402
from navillm_tpu.models.tokenization import NavTokenizer as JTok  # noqa: E402
from navillm_tpu.models.trie import DenseTrie as JTrie  # noqa: E402
from navillm_tpu.ops.matmul_q4 import matmul_q4 as j_matmul_q4  # noqa: E402
from navillm_tpu.sim import WorldModel  # noqa: E402
from navillm_tpu.utils.config import ConfigDict, TrainArgs  # noqa: E402
from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.agents.mp3d_agent import EvalArgs, R2RAgent  # noqa
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims  # noqa
from navillm_tpu_torch.convert import (flatten_tree, init_llama_params,  # noqa
                                       init_nav_params, params_from_jax)
from navillm_tpu_torch.data.feature_db import (  # noqa: E402
    SyntheticImageFeaturesDB as TFeatures)
from navillm_tpu_torch.data.loaders import Dataloader as TLoader  # noqa
from navillm_tpu_torch.data.r2r import R2RDataset  # noqa: E402
from navillm_tpu_torch.models import decoding as TD  # noqa: E402
from navillm_tpu_torch.models import llama as TL  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402
from navillm_tpu_torch.models import quant as TQ  # noqa: E402
from navillm_tpu_torch.models.tokenization import NavTokenizer  # noqa: E402
from navillm_tpu_torch.models.trie import DenseTrie  # noqa: E402
from navillm_tpu_torch.ops.matmul_q4 import matmul_q4  # noqa: E402
from navillm_tpu_torch.sim import WorldModel as TWorld  # noqa: E402

torch.set_num_threads(1)
TOK = NavTokenizer()
ANSWERS = ["red", "blue", "green", "dark brown", "two", "kitchen"]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(4,), (2, 9), (40,)],
                         ids=["m4", "3d", "m40"])
def test_w8a8_mm_on_int8_weights_matches_jax_exactly(lead, dtype):
    w = (np.random.RandomState(9).randn(64, 48) * 0.1).astype(np.float32)
    wq = JQ._quant_weight(jnp.asarray(w, dtype))
    x = np.random.RandomState(10).randn(*lead, 64).astype(np.float32) * 3
    x.reshape(-1, 64)[1] = 0.0                  # the 1e-6 floor of _act_q
    xj = jnp.asarray(x, dtype)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    tw = {"q": _t(wq["q"]), "s": _t(np.asarray(wq["s"].astype(jnp.float32))
                                    ).to(getattr(torch, dtype))}
    qj, sj = JL._act_q(xj)
    qt, st = TL._act_q(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    got = TL._mm(xt, tw, a8=True)
    want = JL._mm(xj, wq, a8=True)
    assert got.dtype == xt.dtype and tuple(got.shape) == (*lead, 48)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the int32 product itself, against numpy's
    y = TL.int_mm(qt.reshape(-1, 64), tw["q"])
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(qj).reshape(-1, 64).astype(np.int64)
        @ np.asarray(wq["q"]).astype(np.int64))


@pytest.fixture(scope="module")
def quantized():
    """{bits: (JAX llm tree, port llm tree)} of one f32 tiny init."""
    jcfg = JNM.NavModelConfig.tiny(vocab_size=TOK.vocab_size, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=TOK.vocab_size, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    out = {}
    for bits in (8, 4):
        jl = JQ._quantize_llama_impl(pj["llm"], bits)
        out[bits] = (jl, params_from_jax(jax.tree.map(np.asarray, jl),
                                         device="cpu"))
    return jcfg, tcfg, out


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16kv", "kv8"])
@pytest.mark.parametrize("bits,use_trie", [(4, True), (4, False),
                                           (8, True)],
                         ids=["w4a8-trie", "w4a8", "w8a8-trie"])
def test_generate_on_an_int8_activation_tree_matches_jax(quantized, bits,
                                                        use_trie, kv_int8):
    """EQA-style generation (ragged left-padded prompts, the special-token
    mask, the answer trie) with int8 activations on a w4 or int8 tree: the
    port's greedy tokens equal JAX's."""
    jcfg, tcfg, trees = quantized
    jl, tl = trees[bits]
    a8j = dataclasses.replace(jcfg.llm, act_int8=True)
    a8t = dataclasses.replace(tcfg.llm, act_int8=True)
    b, t, n_new = 3, 45, 12
    r = np.random.RandomState(5)
    ids = r.randint(3, TOK.vocab_size, (b, t)).astype(np.int32)
    mask = np.arange(t)[None, :] >= np.array([0, 9, 30])[:, None]
    ids[~mask] = TOK.pad_id
    smask = TOK.special_logit_mask()
    seqs = [TOK.encode(w, add_bos=True) for w in ANSWERS]
    jt, tt = (JTrie(seqs, eos_id=TOK.eos_id),
              DenseTrie(seqs, eos_id=TOK.eos_id)) if use_trie else (None,
                                                                    None)
    kw = dict(eos_id=TOK.eos_id, pad_id=TOK.pad_id, max_new_tokens=n_new,
              kv_int8=kv_int8)
    want = np.asarray(j_generate(jl, a8j, ids, mask, trie=jt,
                                 special_token_mask=smask, **kw))
    got = TD.generate(tl, a8t, ids, mask, trie=tt,
                      special_token_mask=torch.from_numpy(smask), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if use_trie:
        assert all(w in ANSWERS for w in TD.decode_to_text(TOK, got.numpy()))


# ----------------------------------------- streaming evaluation, kv8 --- #
def _runners(bits, act_int8):
    tok = JTok.bpe(max_length=1024, pad_to_multiple=64)
    ttok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    jcfg = JNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=tok.vocab_size, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    # a stop bias, so that the random policy stops at mixed steps
    pj["out_head"]["b"] = pj["out_head"]["b"].at[0].set(2.0)
    pj = dict(pj, llm=JQ._quantize_llama_impl(pj["llm"], bits))
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
        jcfg.llm, act_int8=act_int8))
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(
        tcfg.llm, act_int8=act_int8))
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                                   device="cpu"))
    return (JRunner(jcfg, pj, tok, dims=JDims.tiny()),
            NavModelRunner(tcfg, model, ttok, dims=RolloutDims.tiny()))


def _port_eval(trunner, root, kv_int8):
    feat = trunner.cfg.pano.image_feat_size
    world = TWorld(str(root / "connectivity"))
    ds = R2RDataset(root / "R2R" / "annotations" / "val.json", world)
    ds.init_feat_db(TFeatures(feat))
    args = EvalArgs(seed=0, val_batch_size=2, image_feat_size=feat,
                    prefix_cache=True, kv_int8=kv_int8, device="cpu")
    preds = R2RAgent(args, world, trunner).validate_streaming(
        "R2R", args, T.eval_config(5), TLoader(ds, 2, False), dataset=ds)
    return {p["instr_id"]: p["trajectory"] for p in preds}


def _jax_eval(jrunner, root, kv_int8):
    feat = jrunner.cfg.pano.image_feat_size
    cfg = ConfigDict({
        "Feature": {"image_feat_size": feat, "angle_feat_size": 4},
        "R2R": {"DIR": "R2R",
                "SPLIT": {"val_unseen": "annotations/val.json"}}})
    args = TrainArgs(data_dir=str(root), val_batch_size=2, seed=0)
    args.image_feat_size = feat
    args.prefix_cache = True
    args.kv_int8 = kv_int8
    world = WorldModel(str(root / "connectivity"))
    ds = load_dataset("r2r", args, cfg, training=False, source="R2R",
                      world=world)
    ds.init_feat_db(SyntheticImageFeaturesDB(feat))
    preds = load_agent("r2r", args, world, jrunner).validate_streaming(
        "R2R", args, ConfigDict({"Optim": {"val_max_action_len": {"R2R": 5}}}),
        Dataloader(ds, 2, False), dataset=ds)
    return {p["instr_id"]: p["trajectory"] for p in preds}


@pytest.mark.parametrize("bits", [8, 4], ids=["w8a8", "w4a8"])
def test_streaming_eval_a8_prefix_kv8_matches_jax(bits, tmp_path,
                                                  monkeypatch):
    """W8A8 (int8 tree) or w4a8 (int4 tree), prefix cache and int8 K/V
    compose on the streaming path: every episode is covered through the
    cached step on an int8 cache (every prefill quantized its K/V), the
    trajectories equal JAX's under the same configuration, and at least
    80% equal the weight-only bf16-cache run's (tests/test_kv8.py's
    contract)."""
    T.make_r2r_world(tmp_path, n_episodes=6, rows=4, cols=4, seed=3)
    jr8, tr8 = _runners(bits, act_int8=True)
    stacks = []
    fn = TL.quantize_kv_stack
    monkeypatch.setattr(TL, "quantize_kv_stack",
                        lambda kv: stacks.append(1) or fn(kv))
    headline = _port_eval(tr8, tmp_path, kv_int8=True)
    assert tr8.eval_steps == 0 and tr8.cached_steps > 0
    assert len(stacks) == tr8.prefill_calls > 0
    assert len(headline) == 6
    assert headline == _jax_eval(jr8, tmp_path, kv_int8=True)
    _, tr = _runners(bits, act_int8=False)
    base = _port_eval(tr, tmp_path, kv_int8=False)
    same = sum(base[k] == headline[k] for k in base)
    assert base.keys() == headline.keys() and same >= 0.8 * len(base), same


# ------------------------------------------------- quantized init --- #
@pytest.mark.parametrize("bits", [4, 8])
def test_init_params_quantized_equals_quantize_of_init(bits):
    cfg = TL.LlamaConfig.tiny()
    got = TQ.init_params_quantized(cfg, torch.Generator().manual_seed(3),
                                   bits, "cpu")
    want = TQ.quantize_llama_params(init_llama_params(
        cfg, torch.Generator().manual_seed(3), "cpu"), bits)
    assert TQ.weight_bits(got) == bits
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and torch.equal(fg[k], fw[k]), k


@pytest.mark.parametrize("bits", [4, 8])
def test_init_nav_params_quantize_llm_keeps_the_generator_stream(bits):
    """The quantized LLM draws the numbers the dense one draws, so the
    panorama encoder and the heads drawn after it are the same."""
    cfg = TNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)
    q = init_nav_params(cfg, torch.Generator().manual_seed(1), "cpu",
                        quantize_llm=True, quant_bits=bits)
    d = init_nav_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert TQ.weight_bits(q) == bits
    fq, fd = flatten_tree(q), flatten_tree(d)
    for k in fd:
        if not k.startswith("llm."):
            assert torch.equal(fq[k], fd[k]), k
    want = flatten_tree(TQ.quantize_llama_params(d["llm"], bits))
    for k, v in want.items():
        assert torch.equal(fq["llm." + k], v), k


def test_build_runner_quantizes_without_a_pretrained_path():
    """--mode test --quantize_llm [--act_int8 --kv_int8] without a
    pretrained path: the tiny model's LLM is drawn quantized, act_int8
    reaches its config and kv_int8 the runner."""
    from navillm_tpu_torch.training import train_loop as TTL
    from navillm_tpu_torch.utils.config import TrainArgs as TArgs
    for bits in (8, 4):
        args = TArgs(device="cpu", mode="test", quantize_llm=True,
                     quant_bits=bits, act_int8=True, kv_int8=True)
        runner = TTL.build_runner(args, None)
        assert TQ.weight_bits(runner.model) == bits
        assert runner.cfg.llm.act_int8 and runner.kv_int8
        assert runner.sampling_quant_available() is False


# ----------------------------------------------- f32 x into the K4 --- #
@pytest.mark.parametrize("m,h,o", [(40, 256, 512), (7, 384, 256),
                                   (256, 256, 256)])
def test_matmul_q4_f32_x_matches_pallas_interpret(m, h, o):
    w = (np.random.RandomState(0).randn(h, o) * 0.02).astype(np.float32)
    q4p, s16 = JQ._quant_one4(jnp.asarray(w, jnp.bfloat16))
    s = np.asarray(s16.astype(jnp.float32))
    x = np.random.RandomState(1).randn(m, h).astype(np.float32)
    want = np.asarray(j_matmul_q4(jnp.asarray(x), q4p, jnp.asarray(s),
                                  interpret=True))
    got = matmul_q4(_t(x), _t(np.asarray(q4p)), _t(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, o)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(
        np.abs(want).max(), 1.0)
