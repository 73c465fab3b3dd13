"""navbench/flops.py against hand counts at both configurations' widths."""
import json
from pathlib import Path

import pytest

from navbench import flops as FL
from navbench import weights as W

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name,layers,per_layer", [
    # 4 x 4096^2 (q, k, v, o) + 3 x 4096 x 11008 (gate, up, down)
    ("deepseek-llm-7b", 30, 4 * 4096 ** 2 + 3 * 4096 * 11008),
    # q and o 4096^2, k and v 4096 x 1024 (8 heads of 128), 3 x 4096 x 14336
    ("mistral-7b-v0.3", 32, 2 * 4096 ** 2 + 2 * 4096 * 1024
     + 3 * 4096 * 14336),
])
def test_layer_weights(name, layers, per_layer):
    assert FL.llm_matmul_weights(cfg(name)) == layers * per_layer
    assert FL.llm_tokens_flops(cfg(name), 10) == 2.0 * 10 * layers * per_layer


@pytest.mark.parametrize("name,total,layers", [
    ("deepseek-llm-7b", 6.91e9, 6.07e9), ("mistral-7b-v0.3", 7.25e9, 6.98e9)])
def test_published_sizes(name, total, layers):
    n = W.param_count(cfg(name))
    llm = n["llm_embed"] + n["llm_layers"]
    assert abs(llm - total) / total < 0.005
    assert abs(n["llm_layers"] - layers) / layers < 0.005


def test_attention_pairs():
    c = cfg("mistral-7b-v0.3")
    # a causal run of 3 tokens after 5 cached keys: 3 x 5 + 3 + 2 + 1
    pairs = 3 * 5 + 6
    assert FL.llm_attn_flops(c, 3, 5) == 4.0 * 128 * 32 * pairs * 32
    assert FL.attn_pairs(4, 4, True) == 10 and FL.attn_pairs(4, 6, False) == 24


def test_fwd_bound_by_bytes():
    # B=4, T=S=1024, 32/32 heads of 128: chip_smoke's K1 shape, 0.0402 ms
    ms, by = FL.fwd_bound(4, 1024, 1024, 32, 32, 128, True)
    assert by == "bytes" and abs(ms - 0.0402) < 5e-4
    c = cfg("deepseek-llm-7b")
    one = FL.fwd_bound(1, 300, 300, 32, 32, 128, True)[0] * 1e-3 * 30
    assert FL.attn_bound_s(c, 300) == pytest.approx(one)


def test_bwd_and_q4_bounds():
    k2, k3 = FL.bwd_bounds(16, 1024, 32, 128)
    assert k2[1] == "operations" and abs(k2[0] - 0.2782) < 1e-3
    assert abs(k3[0] - 0.2416) < 1e-3
    ms, by = FL.q4_bound(4096, 4096, 11008, 128, "w4")
    assert by == "operations" and abs(ms - 0.3735) < 1e-3


def test_step_work_counts_only_given_rows():
    c = cfg("deepseek-llm-7b")
    f1, b1 = FL.step_work(c, [(300, 0, 40, 10, True)])
    f2, b2 = FL.step_work(c, [(300, 0, 40, 10, True)] * 2)
    assert f2 == pytest.approx(2 * f1) and b2 == pytest.approx(2 * b1)
    fc, bc = FL.step_work(c, [(100, 200, 40, 10, False)])
    assert bc == 0.0
    assert fc == pytest.approx(FL.llm_tokens_flops(c, 100)
                               + FL.llm_attn_flops(c, 100, 200)
                               + FL.pano_flops(c, 40)
                               + FL.fusion_flops(c, 10, 40))
