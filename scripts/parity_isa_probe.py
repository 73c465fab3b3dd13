"""Gradient parity of the port against the JAX package across CPU
instruction sets, on the object-grounding batches of
tests/test_torch_reverie_soon.py (REVERIE and SOON, a teacher batch and
a forced DAgger batch each): the batches whose llm.embed elements part
the two packages by the most.

A child process per setting of scripts/parity_sweep.sh runs each batch
through both packages twice: on the weights the JAX init gives under that
setting (as the tests run), and on the weights it gives under the default
setting (saved by the first child), so that JAX can be held against
itself across XLA settings. It prints per batch:

- port against JAX under each setting, on that setting's init;
- JAX under each XLA setting against JAX under the default, on the same
  weights;

each as the count of elements outside assert_allclose's rule (rtol 2e-3,
atol 2e-5), the least testing.GRAD_ROW_C that would pass the worst of
them, and the worst |got - want| / testing.grad_bound. Writes its
gradients under OUT (default build/parity_probe). About a minute per
setting on the CPU.

    python scripts/parity_isa_probe.py [--out DIR] [SETTING ...]
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = {
    "default": {},
    "xla_sse42": {"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2"},
    "xla_avx": {"XLA_FLAGS": "--xla_cpu_max_isa=AVX"},
    "xla_avx2": {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"},
    "aten_default": {"ATEN_CPU_CAPABILITY": "default"},
    "aten_avx2": {"ATEN_CPU_CAPABILITY": "avx2"},
    "aten_avx512": {"ATEN_CPU_CAPABILITY": "avx512"},
    "xla_sse42+aten_default": {"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2",
                               "ATEN_CPU_CAPABILITY": "default"},
}
BATCHES = [(task, dagger) for task in ("REVERIE", "SOON")
           for dagger in (False, True)]
RTOL, ATOL = 2e-3, 2e-5


def _child(out: Path, setting: str):
    """Run every batch on this setting's init and on the default's."""
    import tempfile

    import jax
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import test_torch_reverie_soon as RS
    from navillm_tpu_torch import testing as T

    jax.config.update("jax_platforms", "cpu")
    jcfg, pj, tcfg, tok, ttok = RS.models.__wrapped__()
    leaves, tree = jax.tree_util.tree_flatten(pj)
    fixed = out / "default_init.npz"
    if setting == "default":
        np.savez(fixed, *[np.asarray(x) for x in leaves])
    saved = np.load(fixed)
    pj_fixed = jax.tree_util.tree_unflatten(tree, [
        jax.numpy.asarray(saved[f"arr_{i}"]) for i in range(len(leaves))])
    with tempfile.TemporaryDirectory(dir=out) as root:
        root = Path(root)
        T.make_r2r_world(root, n_episodes=8, rows=4, cols=4, seed=3,
                         split="train")
        T.make_r2r_world(root, n_episodes=6, rows=4, cols=4, seed=4,
                         split="val")
        for init, p in (("own", pj), ("fixed", pj_fixed)):
            models = (jcfg, p, tcfg, tok, ttok)
            for task, dagger in BATCHES:
                kw = {}
                if dagger:
                    forced, _ = RS._expert_forced(models, root, task)
                    kw = dict(dagger=True, forced=forced)
                for port in (False, True):
                    grads = RS._train(port, models, root, task, **kw)[1]
                    np.savez(out / _name(setting, init, task, dagger, port),
                             **grads)


def _name(setting, init, task, dagger, port):
    kind = "dagger" if dagger else "teacher"
    side = "port" if port else "jax"
    return f"{setting}.{init}.{task}.{kind}.{side}.npz"


def _compare(got, want):
    """(elements outside assert_allclose's rule, the GRAD_ROW_C the worst
    needs, the worst ratio to grad_bound) over every leaf."""
    from navillm_tpu_torch import testing as T
    n_over, need, worst = 0, 0.0, 0.0
    for name in want.files:
        g = got[name].astype(np.float64)
        w = want[name].astype(np.float64)
        d = np.abs(g - w)
        over = d > ATOL + RTOL * np.abs(w)
        n_over += int(over.sum())
        if over.any():
            rows = w.reshape(-1, w.shape[-1]) if w.ndim else w.reshape(1, 1)
            rms = np.sqrt(np.mean(np.square(rows), -1, keepdims=True))
            rms = np.broadcast_to(rms, rows.shape).reshape(w.shape)
            need = max(need, float(((d - ATOL) / (RTOL * rms))[over].max()))
        worst = max(worst, float(T.grad_ratio(g, w, RTOL, ATOL).max()))
    return n_over, need, worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "parity_probe"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("settings", nargs="*", default=list(SETTINGS))
    a = ap.parse_args()
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if a.child:
        return _child(out, a.child)
    settings = ["default"] + [s for s in a.settings if s != "default"]
    for s in settings:
        env = {**os.environ, "JAX_PLATFORMS": "cpu", **SETTINGS[s]}
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                            "--xla_force_host_platform_device_count=8").strip()
        subprocess.run([sys.executable, __file__, "--out", str(out),
                        "--child", s], env=env, check=True, cwd=ROOT)
    sys.path.insert(0, str(ROOT))
    rows = []
    for task, dagger in BATCHES:
        for s in settings:
            def load(init, setting, port):
                return np.load(out / _name(setting, init, task, dagger, port))
            rows.append(("port vs JAX", task, dagger, s, *_compare(
                load("own", s, True), load("own", s, False))))
            if s != "default" and "XLA_FLAGS" in SETTINGS[s]:
                rows.append(("JAX vs JAX default", task, dagger, s,
                             *_compare(load("fixed", s, False),
                                       load("fixed", "default", False))))
    for r in rows:
        print(json.dumps(dict(zip(("pair", "task", "dagger", "setting",
                                   "n_over_allclose", "grad_row_c_needed",
                                   "worst_ratio_to_grad_bound"), r))))


if __name__ == "__main__":
    main()
