"""The CUDA flash-attention kernel against its plain PyTorch version.

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
    flash_attention_fwd, flash_attention_fwd_reference)

torch.set_num_threads(1)


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
    # bf16 outputs: a few bf16 ulps of values of magnitude <= ~1
    torch.testing.assert_close(o.float()[ok], ro.float()[ok],
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse.transpose(1, 2)[ok],
                               rlse.transpose(1, 2)[ok], rtol=0, atol=2e-3)


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
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)


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
    with pytest.raises(RuntimeError):
        flash_attention_fwd(q.requires_grad_(), k, v, mask, causal=True,
                            scale=0.1)


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
