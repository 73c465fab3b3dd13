"""The port's 8-bit Adam moments (training/optim.py:AdamQ8) against the JAX
package's make_optimizer(moments_8bit=True) (scale_by_adam_q8).

The quantizers give the JAX codes and scales; three steps over a tree with
a small leaf (exact f32 moments), a coded matrix, a matrix whose last axis
takes a whole-axis group, and a stacked [L, ...] leaf updated in slices
give JAX's moments and parameters (bit for bit without clipping; within
rtol 1e-6 / atol 1e-6 where the two global norms part in the last ulp);
checkpoints cross both ways under the JAX package's keys; and the closeness
bound of tests/test_optim8.py holds against exact AdamW.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from navillm_tpu.training import checkpoints as JC  # noqa: E402
from navillm_tpu.training import optim as JO  # noqa: E402
from navillm_tpu_torch.convert import flatten_tree  # noqa: E402
from navillm_tpu_torch.training import checkpoints as TC  # noqa: E402
from navillm_tpu_torch.training import optim as TO  # noqa: E402

torch.set_num_threads(1)
FIELDS = ("qm", "ms", "qv", "vs")


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(64, 256) * 0.1).astype(np.float32),
            "odd": rng.randn(33, 130).astype(np.float32),
            "b": rng.randn(64).astype(np.float32),
            "stk": rng.randn(3, 16, 512).astype(np.float32)}


def _t(tree):
    return {n: torch.from_numpy(np.array(v))
            for n, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("shape,group", [((8, 512), 256), ((3, 4, 130), 130),
                                         ((2, 256), 256)])
def test_quantizers_match_jax(shape, group):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    x[0, ..., :group] = 0.0                               # a zero group
    v = (10.0 ** rng.uniform(-8, -2, shape)).astype(np.float32)
    v[-1, ..., :group] = 0.0
    for q_t, q_j, dq_t, dq_j, a in (
            (TO.quantize_signed, JO.quantize_signed, TO.dequantize_signed,
             JO.dequantize_signed, x),
            (TO.quantize_sqrt, JO.quantize_sqrt, TO.dequantize_sqrt,
             JO.dequantize_sqrt, v)):
        qt, st = q_t(torch.from_numpy(a), group)
        qj, sj = q_j(jnp.asarray(a), group)
        assert qt.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[
            np.asarray(qj).dtype.type]
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(dq_t(qt, st, group).numpy(),
                                      np.asarray(dq_j(qj, sj, group)))
        assert (st.numpy() == 1.0).any()                  # zero group: 1


def _run_both(clip, wd, steps=3, slice_elements=None, monkeypatch=None):
    """3 steps of both optimizers from the same tree and gradients (norms
    ~64, ~3 and ~13; the LR still warming up). Returns per step the JAX
    (params, state) and the port's (params, optimizer) snapshots."""
    if slice_elements is not None:
        monkeypatch.setattr(TO, "_SLICE_ELEMENTS", slice_elements)
    tree = _tree()
    rng = np.random.RandomState(7)
    grads = [jax.tree.map(lambda x: (s * rng.randn(*x.shape))
                          .astype(np.float32), tree)
             for s in (1.0, 0.05, 0.2)][:steps]
    tx = JO.make_optimizer(lr=1e-2, num_warmup_steps=4, grad_clip_norm=clip,
                           weight_decay=wd, moments_8bit=True)
    jp = jax.tree.map(jnp.asarray, tree)
    st = tx.init(jp)
    params = _t(tree)
    opt = TO.make_optimizer(params, lr=1e-2, num_warmup_steps=4,
                            grad_clip_norm=clip, weight_decay=wd,
                            moments_8bit=True)
    out = []
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        norm = float(opt.step(_t(g)))
        assert norm == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        out.append((jax.tree.map(np.asarray, jp), st[1][0],
                    {n: p.clone() for n, p in params.items()},
                    {f: {n: t.clone() for n, t in getattr(opt, f).items()}
                     for f in FIELDS}))
    assert opt.count == len(grads)
    return out


def _stored(qm, ms):
    """The moment in its stored domain: m, or sqrt(v) for the second
    moment (the domain its uint8 codes are linear in)."""
    if qm.dtype in (np.int8, np.uint8):
        g = TO._group_size(qm.shape[-1])
        return TO.dequantize_signed(torch.from_numpy(qm.copy()),
                                    torch.from_numpy(ms.copy()), g).numpy()
    return qm if (qm < 0).any() else np.sqrt(qm)


@pytest.mark.parametrize("slice_elements", [None, 1024])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_three_steps_without_clipping_are_bit_exact(weight_decay,
                                                    slice_elements,
                                                    monkeypatch):
    """Also with every leaf updated in slices of 1024 elements (the
    stacked one in 2-row slices)."""
    for jp, jst, params, state in _run_both(
            1e9, weight_decay, slice_elements=slice_elements,
            monkeypatch=monkeypatch):
        for f in FIELDS:
            want = flatten_tree(jax.tree.map(np.asarray, getattr(jst, f)))
            assert sorted(want) == sorted(state[f])
            for n, w in want.items():
                got = state[f][n].numpy()
                assert got.dtype == w.dtype and got.shape == w.shape, (f, n)
                np.testing.assert_array_equal(got, w, err_msg=f"{f} {n}")
        want = flatten_tree(jp)
        for n, p in params.items():
            np.testing.assert_array_equal(p.numpy(), want[n], err_msg=n)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_three_steps_with_clipping_match_jax(weight_decay):
    """Steps 1 and 3 clip at 5, where the two global norms part in their
    last ulps: the same codes, the moments in their stored domains (m and
    sqrt(v)) within rtol 1e-6 of each element and of the leaf's largest
    (an exact f32 moment that nearly cancels keeps the absolute error of
    its terms), and the parameters within test_torch_optim.py's atol
    1e-6."""
    for jp, jst, params, state in _run_both(5.0, weight_decay):
        for fm, fs in (("qm", "ms"), ("qv", "vs")):
            wq = flatten_tree(jax.tree.map(np.asarray, getattr(jst, fm)))
            ws = flatten_tree(jax.tree.map(np.asarray, getattr(jst, fs)))
            for n in wq:
                gq, gs = state[fm][n].numpy(), state[fs][n].numpy()
                if gq.dtype != np.float32:
                    np.testing.assert_array_equal(gq, wq[n], f"{fm} {n}")
                want = _stored(wq[n], ws[n])
                np.testing.assert_allclose(
                    _stored(gq, gs), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max(), err_msg=f"{fm} {n}")
        want = flatten_tree(jp)
        for n, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[n], rtol=0,
                                       atol=1e-6, err_msg=n)


def test_slices_do_not_change_the_step(monkeypatch):
    """The stacked leaf in slices of 2 rows (and the others in theirs) gives
    the step of one slice per leaf, bit for bit."""
    whole = _run_both(5.0, 0.01)[-1]
    sliced = _run_both(5.0, 0.01, slice_elements=1024,
                       monkeypatch=monkeypatch)[-1]
    for n in whole[2]:
        assert torch.equal(whole[2][n], sliced[2][n]), n
        for f in FIELDS:
            assert torch.equal(whole[3][f][n], sliced[3][f][n]), (f, n)


def test_state_layout_and_small_leaf_exactness():
    params = _t(_tree())
    opt = TO.make_optimizer(params, moments_8bit=True)
    assert isinstance(opt, TO.AdamQ8)
    assert opt.qm["w"].dtype == torch.int8 and opt.qv["w"].dtype == \
        torch.uint8 and opt.qm["w"].shape == params["w"].shape
    assert opt.ms["w"].shape == (64, 1) and opt.ms["odd"].shape == (33, 1)
    assert opt.ms["stk"].shape == (3, 16, 2)
    assert opt.qm["b"].dtype == torch.float32 and opt.ms["b"].shape == ()
    # the small leaf follows exact scale_by_adam (lr 1 from 0: the
    # parameter is the update)
    zero = {n: torch.zeros_like(p) for n, p in params.items()}
    step = TO.make_optimizer(zero, lr=1.0, grad_clip_norm=1e9,
                             moments_8bit=True)
    g = np.random.RandomState(2).randn(64).astype(np.float32)
    step.step({n: (torch.from_numpy(g) if n == "b" else torch.ones_like(p))
               for n, p in zero.items()})
    ref = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    rupd, _ = ref.update({"b": jnp.asarray(g)}, ref.init({"b": jnp.zeros(64)}))
    np.testing.assert_allclose(zero["b"].numpy(), -np.asarray(rupd["b"]),
                               rtol=1e-6)
    # moment bytes: int8 + uint8 codes and f32 scales, f32 for "b"
    dense = TO.make_optimizer(_t(_tree()))
    assert dense.moment_bytes() == 2 * 4 * sum(p.numel()
                                               for p in params.values())
    assert opt.moment_bytes() < 0.3 * dense.moment_bytes()


def test_regression_tracks_exact_adamw():
    """tests/test_optim8.py's closeness bound on the port: noisy linear
    regression, 80 steps, the 8-bit run within 10% of exact AdamW's final
    loss (and well optimized)."""
    rng = np.random.RandomState(3)
    X = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((64, 80)).astype(np.float32))
    Y = X @ W

    def run(moments_8bit):
        p = {"w": torch.zeros(64, 80)}
        opt = TO.make_optimizer(p, lr=3e-2, grad_clip_norm=1e9,
                                moments_8bit=moments_8bit)
        for _ in range(80):
            w = p["w"].clone().requires_grad_(True)
            loss = ((X @ w - Y) ** 2).mean()
            loss.backward()
            opt.step({"w": w.grad})
        return float(((X @ p["w"] - Y) ** 2).mean())
    exact, q8 = run(False), run(True)
    assert q8 <= max(exact * 1.10, exact + 1e-4), (exact, q8)
    assert q8 < 3.0


def _jax_state_after_steps(tree, n=2):
    tx = JO.make_optimizer(lr=1e-2, num_warmup_steps=3, moments_8bit=True)
    jp = jax.tree.map(jnp.asarray, tree)
    st = tx.init(jp)
    rng = np.random.RandomState(5)
    for _ in range(n):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.randn(*x.shape).astype(np.float32)), tree)
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
    return tx, jp, st


def test_jax_q8_checkpoint_restores_into_port_and_back(tmp_path):
    """A JAX npz checkpoint with 8-bit moments restores into the port (the
    keys derived from that save), and the port's save restores into
    JAX: codes, scales, small-leaf moments and counts bit for bit."""
    tree = _tree()
    tx, jp, st = _jax_state_after_steps(tree)
    JC.save_checkpoint(tmp_path / "j", jp, st, epoch=3)
    jkeys = set(np.load(tmp_path / "j.npz").files)
    for f in FIELDS:
        assert f"{TC.OPT_STATE}{f}/stk" in jkeys
    assert TC.OPT_COUNT in jkeys and TC.OPT_SCHEDULE_COUNT in jkeys

    params = _t(_tree(seed=9))
    opt = TO.make_optimizer(params, lr=1e-2, num_warmup_steps=3,
                            moments_8bit=True)
    _, _, resume = TC.load_checkpoint(tmp_path / "j", params, opt)
    assert resume == 4 and opt.count == 2
    q8 = st[1][0]
    want = flatten_tree(jax.tree.map(np.asarray, jp))
    for n, p in params.items():
        np.testing.assert_array_equal(p.numpy(), want[n])
    for f in FIELDS:
        wf = flatten_tree(jax.tree.map(np.asarray, getattr(q8, f)))
        for n, w in wf.items():
            np.testing.assert_array_equal(getattr(opt, f)[n].numpy(), w)

    TC.save_checkpoint(tmp_path / "t", params, opt, epoch=5)
    assert set(np.load(tmp_path / "t.npz").files) == jkeys
    live = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree))
    p2, st2, resume = JC.load_checkpoint(tmp_path / "t", live,
                                         tx.init(live))
    assert resume == 6 and int(st2[1][0].count) == 2
    for f in FIELDS:
        a = flatten_tree(jax.tree.map(np.asarray, getattr(st2[1][0], f)))
        b = flatten_tree(jax.tree.map(np.asarray, getattr(q8, f)))
        for n in b:
            np.testing.assert_array_equal(a[n], b[n])


def test_bf16_step_and_torch_backend_round_trip(tmp_path, monkeypatch):
    """bf16 parameters (the 7B dtype): coded moments, updates of about lr,
    and the torch checkpoint backend restores the state bit for bit, so the
    next step is the same."""
    g0 = torch.Generator().manual_seed(0)
    params = {"w": (torch.randn((3, 32, 256), generator=g0) * 0.01)
              .bfloat16(),
              "b": torch.zeros(256, dtype=torch.bfloat16)}
    opt = TO.make_optimizer(params, lr=1e-3, moments_8bit=True)
    grads = {n: torch.full_like(p, 0.5) for n, p in params.items()}
    before = params["w"].clone()
    opt.step({n: g.clone() for n, g in grads.items()})
    assert opt.qm["w"].dtype == torch.int8 and opt.qm["b"].dtype == \
        torch.float32
    torch.testing.assert_close((before - params["w"]).float().abs().mean(),
                               torch.tensor(1e-3), rtol=0.1, atol=0)
    monkeypatch.setattr(TC, "TORCH_THRESHOLD_BYTES", 1)
    TC.save_checkpoint(tmp_path / "ck", params, opt, epoch=0)
    params2 = {n: torch.zeros_like(p) for n, p in params.items()}
    opt2 = TO.make_optimizer(params2, lr=1e-3, moments_8bit=True)
    TC.load_checkpoint(tmp_path / "ck", params2, opt2)
    for a, b in ((opt, opt2),):
        for f in FIELDS:
            for n in params:
                assert torch.equal(getattr(a, f)[n], getattr(b, f)[n])
    opt.step({n: g.clone() for n, g in grads.items()})
    opt2.step({n: g.clone() for n, g in grads.items()})
    for n in params:
        assert torch.equal(params[n], params2[n]), n
