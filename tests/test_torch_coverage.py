"""Every module of the JAX package has its counterpart in the port.

The walk reads navillm_tpu/**/*.py as files and imports none of them. A
module maps to the port module at the same path below navillm_tpu_torch/,
or to the one PAIRED names (modules the port merged or moved), or stands
in EXCLUDED with the reason the port needs no counterpart. A module added
to the JAX package later fails here until it is ported or its exclusion
is argued.
"""
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "navillm_tpu"
PORT = ROOT / "navillm_tpu_torch"

# JAX module -> port module, both relative to their package
PAIRED = {
    # the dataset registry and the datasets sit directly in data/
    "data/datasets/__init__.py": "data/datasets.py",
    # the MP3D base dataset's annotations, __getitem__ and get_obs are the
    # R2R dataset's, which the other navigation datasets extend
    "data/datasets/mp3d_base.py": "data/r2r.py",
    **{f"data/datasets/{m}.py": f"data/{m}.py"
       for m in ("aug", "cvdn", "eqa", "llava", "r2r", "reverie", "scanqa",
                 "soon")},
}

# JAX module -> why the port has no counterpart
EXCLUDED = {
    "utils/jax_cache.py": "JAX's persistent compilation cache: the port "
                          "compiles no XLA program, and nvcc's outputs are "
                          "cached in build/navillm_tpu_torch/ by source hash",
}


def jax_modules():
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def counterpart(module: str) -> str:
    return PAIRED.get(module, module)


def unported(modules):
    """The modules with neither a port counterpart nor an exclusion."""
    return [m for m in modules
            if m not in EXCLUDED and not (PORT / counterpart(m)).is_file()]


@pytest.mark.parametrize("module", jax_modules())
def test_jax_module_has_a_port_counterpart(module):
    if module in EXCLUDED:
        assert EXCLUDED[module].strip()
        # a module the port gained after all leaves the exclusions
        assert not (PORT / module).exists(), module
    else:
        assert (PORT / counterpart(module)).is_file(), (
            f"navillm_tpu/{module} has no counterpart "
            f"navillm_tpu_torch/{counterpart(module)}: port it, or argue "
            f"its exclusion in EXCLUDED")


def test_a_new_jax_module_fails_the_walk():
    modules = jax_modules()
    assert len(modules) > 50 and "data/prefetch.py" in modules
    assert not unported(modules)
    assert unported([*modules, "data/new_store.py"]) == ["data/new_store.py"]


def test_pairings_and_exclusions_name_real_modules():
    modules = set(jax_modules())
    assert set(PAIRED) <= modules and set(EXCLUDED) <= modules
    assert not set(PAIRED) & set(EXCLUDED)
    for target in PAIRED.values():
        assert (PORT / target).is_file(), target
