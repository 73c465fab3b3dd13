"""Port device memory + fused eval step vs the JAX package.

Three eval steps on the same inputs through navillm_tpu's
device_memory.eval_step and the port's, each side carrying its own
state: step 1 from empty memory, step 2 accumulating, step 3 with a
refilled slot (reset), a forced action and an inactive row. f32,
tolerance 1e-4 relative; actions must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from navillm_tpu.agents import device_memory as JDM  # noqa: E402
from navillm_tpu.models import nav_model as JNM  # noqa: E402
from navillm_tpu.models.pano_encoder import forward_panorama  # noqa: E402
from navillm_tpu.testing import synthetic_nav_batch  # noqa: E402
from navillm_tpu_torch.agents import device_memory as TDM  # noqa: E402
from navillm_tpu_torch.convert import params_from_jax  # noqa: E402
from navillm_tpu_torch.models import nav_model as TNM  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
B, V, G, HH, M = 3, 6, 10, 4, 16


def _step_inputs(cfg, seed):
    r = np.random.RandomState(seed)
    pano = {"view_img_fts": r.randn(B, V, cfg.pano.image_feat_size)
            .astype(np.float32),
            "view_lens": r.randint(2, V + 1, B).astype(np.int32),
            "loc_fts": r.randn(B, V, cfg.pano.loc_size).astype(np.float32),
            "nav_types": r.randint(0, 2, (B, V)).astype(np.int32)}
    batch = synthetic_nav_batch(cfg, b=B, g=G, v=V + 1, c=4, hh=HH,
                                tlen=40, seed=seed)
    for k in ("gmap_img_embeds", "vp_img_embeds", "hist_embeds"):
        del batch[k]
    slot_ids = np.full((B, G), -1, np.int32)
    for i in range(B):
        slot_ids[i, 1:6] = r.choice(M, 5, replace=False)
    batch["slot_ids"] = slot_ids
    cur_ids = r.randint(0, M, B).astype(np.int32)
    cur_ids[-1] = -1
    cand_ids = r.randint(-1, M, (B, V)).astype(np.int32)   # repeats too
    return pano, batch, cur_ids, cand_ids


def test_eval_step_matches_jax():
    jcfg = JNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)
    tcfg = TNM.NavModelConfig.tiny(vocab_size=300, use_obj=False)
    pj = JNM.init_nav_params(jax.random.PRNGKey(0), jcfg)
    model = TNM.NavModel(tcfg, params_from_jax(jax.tree.map(np.asarray, pj)))

    def pano_apply(params, rng, pano_in, deterministic):
        return forward_panorama(params["pano"], jcfg.pano,
                                pano_in["view_img_fts"], pano_in["view_lens"],
                                loc_fts=pano_in["loc_fts"],
                                nav_types=pano_in["nav_types"])

    h = jcfg.hidden_size
    sj = JDM.init_memory(B, M, HH, h, jnp.float32)
    st = TDM.init_memory(B, M, HH, h, torch.float32)
    no = np.zeros(B, bool)
    steps = [  # (reset_mask, active_mask, a_t_override)
        (no, ~no, np.full(B, -1, np.int32)),
        (no, ~no, np.full(B, -1, np.int32)),
        (np.array([False, True, False]), np.array([True, True, False]),
         np.array([2, -1, -1], np.int32)),
    ]
    for n, (reset, active, override) in enumerate(steps):
        pano, batch, cur_ids, cand_ids = _step_inputs(jcfg, seed=10 + n)
        sj, aj, lj = JDM.eval_step(pj, jcfg, pano_apply, sj, pano, batch,
                                   reset, cur_ids, cand_ids, active,
                                   override, None, False, 1.0)

        def t(x):
            return {k: torch.from_numpy(v) for k, v in x.items()} \
                if isinstance(x, dict) else torch.from_numpy(x)
        st, at, lt = TDM.eval_step(model, tcfg, st, t(pano), t(batch),
                                   t(reset), t(cur_ids), t(cand_ids),
                                   t(active), t(override))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for k in sj:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       err_msg=f"step {n} {k}", **TOL)
    assert int(st["hist_cnt"][2]) == 2        # the inactive row kept still
    assert int(st["hist_cnt"][1]) == 1        # the refilled row restarted
