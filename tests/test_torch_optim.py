"""The port's optimizer against the JAX package's optax chain.

make_optimizer on both sides (clip_by_global_norm -> AdamW -> constant
with warmup), three steps on a small tree of f32 leaves with the same
gradients: the first and third steps clip (global norm above the limit),
the second does not, and the LR is still warming up.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from navillm_tpu.training.optim import make_optimizer as j_make  # noqa: E402
from navillm_tpu_torch.convert import flatten_tree  # noqa: E402
from navillm_tpu_torch.training.optim import (  # noqa: E402
    constant_with_warmup, global_norm, make_optimizer)

torch.set_num_threads(1)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_three_steps_match_optax(weight_decay):
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(4, 6).astype(np.float32),
            "b": {"w": rng.randn(3, 5, 2).astype(np.float32),
                  "s": rng.randn(7).astype(np.float32)}}
    # global norms ~ 60, ~ 3 and ~ 12 against a limit of 5
    grads = [jax.tree.map(lambda x: (scale * rng.randn(*x.shape))
                          .astype(np.float32), tree)
             for scale in (10.0, 0.5, 2.0)]
    lr, warmup, clip = 1e-2, 4, 5.0

    tx = j_make(lr=lr, num_warmup_steps=warmup, grad_clip_norm=clip,
                weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    params = {n: torch.from_numpy(v.copy())
              for n, v in flatten_tree(tree).items()}
    opt = make_optimizer(params, lr=lr, num_warmup_steps=warmup,
                         grad_clip_norm=clip, weight_decay=weight_decay)
    norms = []
    for g in grads:
        flat = {n: torch.from_numpy(v.copy())
                for n, v in flatten_tree(g).items()}
        want_norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                for v in flatten_tree(g).values()))
        norms.append(float(opt.step(flat)))
        assert norms[-1] == pytest.approx(want_norm, rel=1e-5)
    assert norms[0] > clip > norms[1] and norms[2] > clip
    assert opt.count == 3

    want = flatten_tree(jax.tree.map(np.asarray, jp))
    for n, p in params.items():
        # f32 on both sides: Adam's update is O(lr) per step and the two
        # round their divisions in other places
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0, atol=1e-6,
                                   err_msg=n)
        assert p.dtype == opt.mu[n].dtype == opt.nu[n].dtype


def test_schedule_and_norm():
    sched = constant_with_warmup(2.0, 4)
    assert [sched(s) for s in range(6)] == [0.5, 1.0, 1.5, 2.0, 2.0, 2.0]
    assert constant_with_warmup(3.0, 0)(0) == 3.0
    g = [torch.full((2, 2), 3.0, dtype=torch.bfloat16), torch.tensor([4.0])]
    n = global_norm(g)
    assert n.dtype == torch.float32 and float(n) == pytest.approx(
        np.sqrt(4 * 9 + 16))


def test_bf16_moments_stay_bf16():
    """Moments live in the parameter's dtype (optax's scale_by_adam for a
    bf16 tree), and a step moves a bf16 weight by about lr."""
    p = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    opt = make_optimizer(p, lr=1e-2)
    opt.step({"w": torch.linspace(-1, 1, 8).to(torch.bfloat16)})
    assert opt.mu["w"].dtype == opt.nu["w"].dtype == torch.bfloat16
    torch.testing.assert_close(p["w"].float().abs(),
                               torch.full((8,), 1e-2), rtol=1e-2, atol=0)
