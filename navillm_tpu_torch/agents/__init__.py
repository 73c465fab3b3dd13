"""Agent registry (twin of navillm_tpu/agents/__init__.py; reference
tasks/agents/__init__.py:12-14). ``r2r``, ``eqa``, ``reverie`` and
``soon`` are registered;
the JAX package's other agents raise NotImplementedError naming their
ROADMAP item."""
from ..utils.registry import AGENTS


def load_agent(name: str, *args, **kwargs):
    return AGENTS.build(name, *args, **kwargs)


from . import mp3d_agent  # noqa: E402,F401 isort:skip
