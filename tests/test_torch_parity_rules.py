"""The shared gradient-parity rule (testing.assert_grads_close) against
faults planted in real gradients.

The port's and the JAX package's gradients of one REVERIE teacher batch
with the OG head (tests/test_torch_reverie_soon.py) pass the rule; each
planted fault in the port's side must fail it: a leaf scaled by 1.01, one
row of llm.embed zeroed, the sign of the smallest leaf flipped, obj_pos.w
taken from another batch (the SOON teacher batch), one element moved by
10x its bound. And the case the rule exists for passes: an element that
cancels down to a small fraction of its row, off by the rounding of
terms the size of the row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the fixtures models and worlds come with the helpers
from test_torch_reverie_soon import (GRAD_ATOL, GRAD_RTOL,  # noqa: E402
                                     _train, models, worlds)  # noqa: F401
from navillm_tpu_torch import testing as T  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grads(models, worlds):
    """(port, JAX) gradients of the REVERIE teacher OG batch, and the
    port's of the SOON one."""
    got = _train(True, models, worlds, "REVERIE")[1]
    want = _train(False, models, worlds, "REVERIE")[1]
    other = _train(True, models, worlds, "SOON")[1]
    return got, want, other


def _scale_leaf(got, want, other):
    return {**got, "llm.layers.wq": got["llm.layers.wq"] * np.float32(1.01)}


def _zero_embed_row(got, want, other):
    g = got["llm.embed"].copy()
    norms = np.abs(want["llm.embed"]).sum(-1)
    live = np.flatnonzero(norms)
    assert live.size > 1
    # the row of median weight among those the batch reaches
    g[live[np.argsort(norms[live])[live.size // 2]]] = 0.0
    return {**got, "llm.embed": g}


def _flip_smallest(got, want, other):
    live = [n for n, w in want.items() if np.abs(w).sum() > 0]
    name = min(live, key=lambda n: (want[n].size, n))
    return {**got, name: -got[name]}


def _other_batch(got, want, other):
    assert not np.array_equal(other["obj_pos.w"], got["obj_pos.w"])
    return {**got, "obj_pos.w": other["obj_pos.w"]}


def _move_one(got, want, other):
    name = "out_head.w"
    w = want[name]
    bound = T.grad_bound(w, GRAD_RTOL, GRAD_ATOL)
    i = np.unravel_index(np.argmax(np.abs(w)), w.shape)
    g = got[name].copy()
    g[i] = w[i] + 10.0 * bound[i]
    return {**got, name: g}


FAULTS = {"leaf_x1.01": _scale_leaf, "embed_row_zeroed": _zero_embed_row,
          "smallest_leaf_negated": _flip_smallest,
          "obj_pos_of_another_batch": _other_batch,
          "one_element_10x_bound": _move_one}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_gradient_rule(grads, fault):
    got, want, other = grads
    assert sorted(got) == sorted(want)
    T.assert_grads_close(got, want, GRAD_RTOL, GRAD_ATOL)
    bad = FAULTS[fault](got, want, other)
    assert any(bad[n] is not got[n] for n in got)
    with pytest.raises(AssertionError, match="elements over"):
        T.assert_grads_close(bad, want, GRAD_RTOL, GRAD_ATOL)


def test_rule_scales_by_the_row_where_an_element_cancels():
    """A row of elements of size ~30, one of which cancels to 5e-3,
    moved by atol + 0.8 * rtol * GRAD_ROW_C * the row's RMS: the rule
    passes it where assert_allclose, which scales by the element alone,
    does not; moved by 1.2x its bound, the rule fails it."""
    r = np.random.RandomState(0)
    w = (r.randn(3, 64) * 30.0).astype(np.float32)
    w[1, 7] = 5e-3
    rms = float(np.sqrt(np.mean(np.square(w[1].astype(np.float64)))))
    g = w.copy()
    g[1, 7] += np.float32(GRAD_ATOL + 0.8 * GRAD_RTOL * T.GRAD_ROW_C * rms)
    T.assert_grads_close(g, w, GRAD_RTOL, GRAD_ATOL, err_msg="cancelled")
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    g[1, 7] = w[1, 7] + np.float32(
        1.2 * T.grad_bound(w, GRAD_RTOL, GRAD_ATOL)[1, 7])
    assert T.grad_ratio(g, w, GRAD_RTOL, GRAD_ATOL).max() == pytest.approx(
        1.2, rel=1e-3)
    with pytest.raises(AssertionError, match="1 of 192 elements over"):
        T.assert_grads_close(g, w, GRAD_RTOL, GRAD_ATOL)
