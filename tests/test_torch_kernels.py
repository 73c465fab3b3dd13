"""The CUDA kernels against their plain PyTorch versions: the
flash-attention forward (csrc/flash_attn_fwd.cu), the dK/dV backward
kernel (csrc/flash_attn_bwd.cu), the dQ backward kernel with its delta
(csrc/flash_attn_bwd_dq.cu) and the int4 matmul (csrc/matmul_q4.cu).

The kernel tests need a Hopper card (compute capability 9.0) and skip
elsewhere. This file imports no jax, so on the card it runs without the
repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from navillm_tpu_torch.ops.attention import (  # noqa: E402
    FlashAttention, attention_delta, attention_eager, flash_attention_bwd,
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_fwd_reference)

from navillm_tpu_torch.testing import attn_excess, visible_keys  # noqa: E402
from navillm_tpu_torch.models.llama import _act_q  # noqa: E402
from navillm_tpu_torch.models.quant import _quant_one4  # noqa: E402
from navillm_tpu_torch.ops.matmul_q4 import (  # noqa: E402
    matmul_q4, matmul_q4_reference)

torch.set_num_threads(1)

# lse against the plain version: f32 on both sides, differing in summation
# order only (~1e-6); hiding a 64-key tile of a flat row of 1024 keys moves
# it by ~0.06
LSE_ATOL = 1e-4
# delta = rowsum(O * dO) from the dQ kernel against attention_delta: every
# product of two bf16 values is exact in f32, so the two differ only in the
# order of the D-term f32 sum, by at most ~D * 2**-24 of the row's sum of
# |O * dO| on each side (2**-17 at D = 128); the bound leaves 4x of that
DELTA_RTOL = 2 ** -15


def _require_sm90():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 (Hopper)")


def _inputs(b, t, s, nh, nkv, d, pads, device, dtype, seed=0):
    """Left-padded kv masks: row i has its first pads[i] keys masked."""
    r = np.random.RandomState(seed)

    def mk(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)) \
            .to(device=device, dtype=dtype)

    q, k, v = mk(b, t, nh, d), mk(b, s, nkv, d), mk(b, s, nkv, d)
    mask = torch.arange(s)[None, :] >= torch.tensor(pads)[:, None]
    return q, k, v, mask.to(device)


def _valid_rows(mask, t, causal):
    """[B, T]: query rows that see at least one valid key."""
    s = mask.shape[1]
    keys = mask[:, None, :].expand(-1, t, -1).clone()
    if causal:
        keys &= torch.ones(t, s, dtype=torch.bool,
                           device=mask.device).tril(s - t)[None]
    return keys.any(-1)


# (b, t, s, nh, nkv, d, causal, left pads per batch row)
CASES = [
    (4, 128, 128, 32, 32, 128, True, [0, 5, 64, 127]),
    (2, 200, 200, 4, 2, 128, True, [0, 130]),        # ragged tile, GQA
    (2, 96, 160, 4, 4, 64, False, [3, 159]),         # cross-attention, D=64
    (1, 640, 640, 8, 8, 128, True, [300]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_flash_kernel_matches_reference(case):
    _require_sm90()
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16)
    with torch.inference_mode():
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                     scale=d ** -0.5)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches == before + 1
        ro, rlse = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                 d ** -0.5)
    assert o.shape == (b, t, nh, d) and o.dtype == torch.bfloat16
    assert lse.shape == (b, nh, t) and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    ok = _valid_rows(mask, t, causal)                        # [B, T]
    assert attn_excess(o, ro, ok) <= 1
    torch.testing.assert_close(lse.transpose(1, 2)[ok],
                               rlse.transpose(1, 2)[ok], rtol=0,
                               atol=LSE_ATOL)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_qkv():
    """q/k/v as views into one fused [B, T, 3, NH, D] projection."""
    _require_sm90()
    b, t, nh, d = 2, 192, 4, 128
    r = np.random.RandomState(3)
    qkv = torch.from_numpy(r.randn(b, t, 3, nh, d).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    q, k, v = qkv.unbind(2)
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        o, _ = flash_attention_fwd(q, k, v, mask, causal=True,
                                   scale=d ** -0.5)
        ro, _ = flash_attention_fwd_reference(q, k, v, mask, True, d ** -0.5)
    assert attn_excess(o, ro, mask) <= 1


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take():
    _require_sm90()
    q, k, v, mask = _inputs(1, 64, 64, 2, 2, 128, [0], "cuda", torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_fwd(q.float(), k.float(), v.float(), mask,
                            causal=True, scale=0.1)
    with pytest.raises(ValueError):
        flash_attention_fwd(q[..., :96], k[..., :96], v[..., :96], mask,
                            causal=True, scale=0.1)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, mask.int(), causal=True, scale=0.1)
    # the raw forward takes inputs that need a gradient, and is not itself
    # differentiable: FlashAttention is
    o, _ = flash_attention_fwd(q.requires_grad_(), k, v, mask, causal=True,
                               scale=0.1)
    assert o.grad_fn is None and not o.requires_grad
    assert FlashAttention.apply(q, k, v, mask, True, 0.1).grad_fn is not None


def test_flash_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is its plain version and counts nothing."""
    q, k, v, mask = _inputs(2, 40, 40, 4, 2, 64, [0, 17], "cpu",
                            torch.float32)
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=0.125)
    ro, rlse = flash_attention_fwd_reference(q, k, v, mask, True, 0.125)
    assert flash_attention_fwd.launches == before
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=0)


# (b, t, nh, nkv, d, causal, left pads per batch row); T == S (self-attention)
BWD_CASES = [
    (2, 256, 8, 8, 128, True, [0, 77]),        # fully masked leading rows
    (2, 200, 4, 2, 128, True, [0, 130]),       # ragged tile, GQA
    (2, 136, 4, 4, 64, False, [5, 135]),       # D=64, one valid key
    (1, 640, 8, 8, 128, True, [300]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_kernels_match_reference(case):
    _require_sm90()
    b, t, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, t, nh, nkv, d, pads, "cuda", torch.bfloat16)
    do = _inputs(b, t, t, nh, nkv, d, pads, "cuda", torch.bfloat16,
                 seed=1)[0]
    scale = d ** -0.5
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                     scale=scale)
        before = (flash_attention_bwd_dkv.launches,
                  flash_attention_bwd_dq.launches)
        got = flash_attention_bwd(q, k, v, mask, o, lse, do, causal=causal,
                                  scale=scale)
        torch.cuda.synchronize()
        assert (flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches) == (before[0] + 1,
                                                     before[1] + 1)
        want = flash_attention_bwd_reference(q, k, v, mask, o, lse, do,
                                             causal, scale)
    ok = _valid_rows(mask, t, causal)                        # [B, T]
    # dQ on the query rows that see a valid key, dK/dV on the valid keys
    for name, a, w, x, rows in zip("qkv", got, want, (q, k, v),
                                   (ok, mask, mask)):
        assert a.shape == x.shape and a.dtype == torch.bfloat16
        assert torch.isfinite(a).all(), f"d{name} not finite"
        assert attn_excess(a, w, rows) <= 1, f"d{name} {case}"
    # query rows that see no valid key contribute nothing: their dQ is 0
    assert not got[0].float()[~ok].any()


@pytest.mark.cuda
def test_flash_attention_function_matches_eager_autograd():
    """FlashAttention on the card against autograd through the eager path,
    with the cotangent zero on rows that see no valid key."""
    _require_sm90()
    b, t, nh, d = 2, 320, 4, 128
    q, k, v, mask = _inputs(b, t, t, nh, nh, d, [0, 100], "cuda",
                            torch.bfloat16)
    g = _inputs(b, t, t, nh, nh, d, [0, 0], "cuda", torch.bfloat16, seed=2)[0]
    g = g * _valid_rows(mask, t, True)[:, :, None, None]
    grads = []
    for fn in (lambda q, k, v: FlashAttention.apply(q, k, v, mask, True,
                                                    d ** -0.5),
               lambda q, k, v: attention_eager(q, k, v, mask, True,
                                               d ** -0.5)):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(g)
        grads.append([x.grad.float() for x in xs])
    for name, a, w in zip("qkv", *grads):
        torch.testing.assert_close(a, w, rtol=2e-2, atol=6e-2,
                                   msg=f"d{name}")


# K1 (wgmma + TMA) and K3 at ragged lengths, GQA, D=64, cross-attention and
# strided views, at chip_smoke.py's phase 2 and 5 tolerances: O, dK, dV and
# dQ per element by testing.attn_excess (a bound scaled by the element and
# its row's RMS, which a hidden key fails: see the CPU test below), and lse
# (f32 on both sides, differing in summation order only, ~1e-6) to LSE_ATOL

# (b, t, s, nh, nkv, d, causal, left pads per batch row)
RAGGED_CASES = [
    (2, 1, 1, 8, 8, 128, True, [0, 0]),
    (2, 63, 63, 8, 8, 128, True, [0, 20]),
    (3, 65, 65, 8, 8, 128, True, [0, 1, 64]),
    (2, 1000, 1000, 8, 8, 128, True, [0, 999]),
    (2, 1000, 1000, 8, 2, 128, True, [0, 400]),      # grouped-query
    (2, 65, 65, 4, 4, 64, True, [0, 33]),            # D = 64
    (2, 1000, 1000, 4, 1, 64, True, [3, 700]),       # D = 64, GQA
    (2, 63, 1000, 8, 8, 128, False, [0, 990]),       # cross-attention
    (2, 1000, 65, 8, 4, 128, False, [0, 64]),
]


def _ids(cases):
    return ["B{}-T{}-S{}-NH{}-NKV{}-D{}-{}".format(
        *c[:6], "causal" if c[6] else "cross") for c in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES, ids=_ids(RAGGED_CASES))
def test_flash_fwd_kernel_ragged_gqa_d64_cross(case):
    _require_sm90()
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16)
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                     scale=d ** -0.5)
        ro, rlse = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                 d ** -0.5)
        torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    ok = _valid_rows(mask, t, causal)
    assert attn_excess(o, ro, ok) <= 1
    torch.testing.assert_close(lse.transpose(1, 2)[ok],
                               rlse.transpose(1, 2)[ok], rtol=0,
                               atol=LSE_ATOL)
    # a row that sees no valid key writes lse = NEG_INF (-1e30)
    assert (lse.transpose(1, 2)[~ok] < -1e29).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES, ids=_ids(RAGGED_CASES))
def test_flash_dq_kernel_ragged_gqa_d64_cross(case):
    _require_sm90()
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16)
    do = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16,
                 seed=1)[0]
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                     scale=d ** -0.5)
        before = flash_attention_bwd_dq.launches
        dq, delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                           causal=causal, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert flash_attention_bwd_dq.launches == before + 1
        # the plain version on the delta the kernel computed (held to
        # attention_delta on its own below)
        want = flash_attention_bwd_dq_reference(q, k, v, mask, lse, delta,
                                                do, causal, d ** -0.5)
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    assert torch.isfinite(dq).all()
    ok = _valid_rows(mask, t, causal)
    assert attn_excess(dq, want, ok) <= 1
    assert not dq.float()[~ok].any()


# K2's cases: RAGGED_CASES, with two valid keys in the short cross-attention
# row: where every query row sees one key alone, P = 1 and dS = P (dP -
# delta) is zero but for rounding, so dK there is a sum of rounding noise
# on both sides, not a check of the kernel
DKV_CASES = [c if c[:7] != (2, 1000, 65, 8, 4, 128, False) else
             c[:7] + ([0, 63],) for c in RAGGED_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DKV_CASES, ids=_ids(DKV_CASES))
def test_flash_dkv_kernel_ragged_gqa_d64_cross(case):
    """K2 (64-key blocks, a 64-row ring of Q and dO) at ragged lengths,
    GQA, D=64 and cross-attention, on the dQ kernel's delta, which the
    plain version takes too."""
    _require_sm90()
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16)
    do = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16,
                 seed=1)[0]
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                     scale=d ** -0.5)
        _, delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                          causal=causal, scale=d ** -0.5)
        before = flash_attention_bwd_dkv.launches
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                         causal=causal, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert flash_attention_bwd_dkv.launches == before + 1
        want_dk, want_dv = flash_attention_bwd_dkv_reference(
            q, k, v, mask, lse, delta, do, causal, d ** -0.5)
    for got, want, x in ((dk, want_dk, k), (dv, want_dv, v)):
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        assert attn_excess(got, want, mask) <= 1
    # keys hidden by the mask get no gradient at all
    assert not dk.float()[~mask].any() and not dv.float()[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES, ids=_ids(RAGGED_CASES))
def test_flash_dq_kernel_delta_matches_attention_delta(case):
    """The delta that the dQ kernel writes against attention_delta, to
    DELTA_RTOL of each row's sum of |O * dO|."""
    _require_sm90()
    b, t, s, nh, nkv, d, causal, pads = case
    q, k, v, mask = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16)
    do = _inputs(b, t, s, nh, nkv, d, pads, "cuda", torch.bfloat16,
                 seed=1)[0]
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                     scale=d ** -0.5)
        _, delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                          causal=causal, scale=d ** -0.5)
        want = attention_delta(o, do)
        size = (o.float() * do.float()).abs().sum(-1).transpose(1, 2)
    assert delta.shape == (b, nh, t) and delta.dtype == torch.float32
    assert ((delta - want).abs() <= DELTA_RTOL * size).all()


@pytest.mark.cuda
def test_flash_dkv_kernel_ignores_rows_that_see_no_valid_key():
    """Query rows that see no valid key (left padding under causal) add
    exactly nothing to dK and dV: new Q and dO on those rows leave both
    bit for bit as they were."""
    _require_sm90()
    b, t, nh, d = 2, 320, 4, 128
    q, k, v, mask = _inputs(b, t, t, nh, nh, d, [0, 200], "cuda",
                            torch.bfloat16)
    do = _inputs(b, t, t, nh, nh, d, [0, 0], "cuda", torch.bfloat16,
                 seed=1)[0]
    dead = ~_valid_rows(mask, t, True)                       # [B, T]
    assert dead.any()
    noise = _inputs(b, t, t, nh, nh, d, [0, 0], "cuda", torch.bfloat16,
                    seed=2)[0] * 8
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=True,
                                     scale=d ** -0.5)
        got = []
        for qq, dd in ((q, do), (torch.where(dead[:, :, None, None], noise, q),
                                 torch.where(dead[:, :, None, None], noise,
                                             do))):
            _, delta = flash_attention_bwd_dq(qq, k, v, mask, lse, o, dd,
                                              causal=True, scale=d ** -0.5)
            got.append(flash_attention_bwd_dkv(qq, k, v, mask, lse, delta, dd,
                                               causal=True, scale=d ** -0.5))
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1],
                                                             got[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(63, 128), (1000, 128), (65, 64)])
def test_flash_kernels_read_views_of_one_fused_projection(t, d):
    """q/k/v (and dO) as non-contiguous views cut from one fused
    [B, T, 3, NH, D] tensor, at ragged lengths."""
    _require_sm90()
    b, nh = 2, 4
    r = np.random.RandomState(4)
    qkv = torch.from_numpy(r.randn(b, t, 3, nh, d).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(r.randn(b, t, 2, nh, d).astype(np.float32)) \
        .to("cuda", torch.bfloat16)[:, :, 1]
    assert not (q.is_contiguous() or do.is_contiguous())
    mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
        [0, t // 3], device="cuda")[:, None]
    scale = d ** -0.5
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=scale)
        ro, rlse = flash_attention_fwd_reference(q, k, v, mask, True, scale)
        dq, delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                           causal=True, scale=scale)
        want = flash_attention_bwd_dq_reference(q, k, v, mask, lse, delta,
                                                do, True, scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                         causal=True, scale=scale)
        want_dk, want_dv = flash_attention_bwd_dkv_reference(
            q, k, v, mask, lse, delta, do, True, scale)
    ok = _valid_rows(mask, t, True)
    assert attn_excess(o, ro, ok) <= 1
    torch.testing.assert_close(lse.transpose(1, 2)[ok],
                               rlse.transpose(1, 2)[ok], rtol=0,
                               atol=LSE_ATOL)
    assert attn_excess(dq, want, ok) <= 1
    assert not dq.float()[~ok].any()
    assert attn_excess(dk, want_dk, mask) <= 1
    assert attn_excess(dv, want_dv, mask) <= 1


def _flat_rows(t, device, seed=5):
    """Causal inputs with q / 8: flat attention rows, where a skipped key
    moves O and the gradients the least."""
    q, k, v, mask = _inputs(2, t, t, 4, 4, 128, [0, t // 4], device,
                            torch.bfloat16, seed=seed)
    do = _inputs(2, t, t, 4, 4, 128, [0, 0], device, torch.bfloat16,
                 seed=seed + 1)[0]
    return q * 0.125, k, v, do, mask


@pytest.mark.cuda
def test_flash_kernels_on_flat_rows():
    """K1, K2 and K3 on flat attention rows, under the same gate."""
    _require_sm90()
    t = 1000
    q, k, v, do, mask = _flat_rows(t, "cuda")
    scale = 128 ** -0.5
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=scale)
        ro, _ = flash_attention_fwd_reference(q, k, v, mask, True, scale)
        dq, delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                           causal=True, scale=scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                         causal=True, scale=scale)
        args = (q, k, v, mask, lse, delta, do)
        want_dq = flash_attention_bwd_dq_reference(*args, True, scale)
        want_dk, want_dv = flash_attention_bwd_reference(
            q, k, v, mask, o, lse, do, True, scale)[1:]
    ok = _valid_rows(mask, t, True)
    assert attn_excess(o, ro, ok) <= 1
    assert attn_excess(dq, want_dq, ok) <= 1
    assert attn_excess(dk, want_dk, mask) <= 1
    assert attn_excess(dv, want_dv, mask) <= 1


@pytest.mark.parametrize("flat", [False, True], ids=["peaked", "flat"])
@pytest.mark.parametrize("out", ["O", "dQ", "dK", "dV"])
def test_attention_gate_passes_rounding_and_fails_a_skipped_key(out, flat):
    """The kernels' gate (testing.attn_excess) passes the plain version
    moved by one bf16 rounding, and fails it with one key hidden from
    (O, dQ) or one query row skipped by (dK, dV) the rows that see 256
    keys or more, on peaked and on flat attention rows."""
    t, scale = 512, 128 ** -0.5
    q, k, v, do, _ = _flat_rows(t, "cpu")
    if not flat:
        q = q * 8
    mask = torch.ones(2, t, dtype=torch.bool)
    o, lse = flash_attention_fwd_reference(q, k, v, mask, True, scale)
    delta = attention_delta(o, do)
    hidden = mask.clone()
    hidden[:, 300] = False
    skipped = lse.clone()
    skipped[:, :, 300] = -1e30
    if out == "O":
        want, bad = o, flash_attention_fwd_reference(q, k, v, hidden, True,
                                                     scale)[0]
    elif out == "dQ":
        want, bad = (flash_attention_bwd_dq_reference(
            q, k, v, m, lse, delta, do, True, scale) for m in (mask, hidden))
    else:
        i = "dKdV".index(out) // 2
        want, bad = (flash_attention_bwd_reference(
            q, k, v, mask, o, lse, do, True, scale)[1 + i],
            flash_attention_bwd_dkv_reference(
                q, k, v, mask, skipped, delta, do, True, scale)[i])
    seen = visible_keys(mask, t, True)
    # rows of O/dQ: query rows; of dK/dV: keys, seen by T - j query rows
    long_rows = (seen if out in ("O", "dQ") else seen.flip(1)) >= 256
    rounded = (want.float() * (1 + 2 ** -8)).to(torch.bfloat16)
    assert attn_excess(rounded, want, seen > 0) <= 1
    assert attn_excess(bad, want, long_rows) > 1


def _q4_inputs(lead, h, o, seed=0, s_dtype=torch.bfloat16):
    """bf16 x [*lead, h], its per-token int8 form, and an int4 weight
    quantized on the card from a bf16 one (scales in s_dtype)."""
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(*lead, h).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    w = torch.from_numpy((r.randn(h, o) * h ** -0.5).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    q4p, s = _quant_one4(w)
    return x, _act_q(x)[0], q4p, s.to(s_dtype)


def _assert_q4_close(got, want, int8_x):
    """int8 x: every group product is exact, so only f32 rounding of the
    same ops in the same order remains (rtol 1e-6). bf16 x: the f32 sums
    differ in order, so after the bf16 cast the two may differ by one bf16
    ulp: 2**-7 of the element, plus 1e-4 of the largest element for
    values near zero, where the f32 order error exceeds their ulp."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    g, w = got.float(), want.float()
    if int8_x:
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    else:
        bound = 2 ** -7 * w.abs() + 1e-4 * w.abs().max()
        assert ((g - w).abs() <= bound).all(), (g - w).abs().max()


# (leading dims, h, o): tiny model dims (G = 128), G = 32 and 64, ragged m
# and o (o/2 not a multiple of 16 bytes), leading dims, the 7B shapes
Q4_CASES = [
    ((7,), 128, 256), ((40,), 256, 512), ((130,), 384, 256),
    ((33,), 96, 200), ((3, 5), 192, 96), ((300,), 4096, 4096),
    ((257,), 4096, 11008), ((129,), 11008, 4096),
]


@pytest.mark.cuda
@pytest.mark.parametrize("int8_x", [False, True], ids=["w4", "w4a8"])
@pytest.mark.parametrize("case", Q4_CASES)
def test_matmul_q4_kernel_matches_reference(case, int8_x):
    _require_sm90()
    lead, h, o = case
    x, xq, q4p, s = _q4_inputs(lead, h, o)
    a = xq if int8_x else x
    before = (matmul_q4.launches, matmul_q4.int8_launches)
    got = matmul_q4(a, q4p, s)
    torch.cuda.synchronize()
    assert (matmul_q4.launches, matmul_q4.int8_launches) == (
        before[0] + 1, before[1] + int(int8_x))
    assert got.shape == (*lead, o)
    assert got.dtype == (torch.float32 if int8_x else torch.bfloat16)
    _assert_q4_close(got, matmul_q4_reference(a, q4p, s), int8_x)


@pytest.mark.cuda
def test_matmul_q4_kernel_f32_scales_and_out_dtypes():
    _require_sm90()
    x, xq, q4p, s = _q4_inputs((65,), 256, 384, seed=1,
                               s_dtype=torch.float32)
    for a, out in ((x, torch.float32), (xq, torch.bfloat16)):
        _assert_q4_close(matmul_q4(a, q4p, s, out_dtype=out),
                         matmul_q4_reference(a, q4p, s, out_dtype=out),
                         int8_x=a.dtype == torch.int8 and
                         out == torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_x", [False, True], ids=["w4", "w4a8"])
@pytest.mark.parametrize("case", [((1000,), 4096, 11008),
                                  ((77,), 11008, 4096)])
def test_matmul_q4_kernel_ragged_m_f32_scales(case, int8_x):
    """m not a multiple of the kernel's 128-row tile, f32 scales, at 7B
    layer shapes."""
    _require_sm90()
    lead, h, o = case
    x, xq, q4p, s = _q4_inputs(lead, h, o, seed=2, s_dtype=torch.float32)
    a = xq if int8_x else x
    _assert_q4_close(matmul_q4(a, q4p, s), matmul_q4_reference(a, q4p, s),
                     int8_x)


@pytest.mark.cuda
def test_matmul_q4_kernel_rejects_what_it_does_not_take():
    _require_sm90()
    x, xq, q4p, s = _q4_inputs((16,), 256, 128)
    with pytest.raises(ValueError):                  # f32 x
        matmul_q4(x.float(), q4p, s)
    with pytest.raises(ValueError):                  # a strided x
        matmul_q4(torch.cat([x, x], -1)[:, 1:257], q4p, s)
    with pytest.raises(ValueError):                  # q4p off its alignment
        buf = torch.empty(q4p.numel() + 1, dtype=torch.uint8, device="cuda")
        buf[1:].copy_(q4p.flatten())
        matmul_q4(x, buf[1:].view(q4p.shape), s)
    x48, xq48, q48, s48 = _q4_inputs((16,), 48, 64)   # G = 16
    matmul_q4(x48, q48, s48)                          # bf16 takes G = 16
    with pytest.raises(ValueError):                   # int8 needs G % 32
        matmul_q4(xq48, q48, s48)
