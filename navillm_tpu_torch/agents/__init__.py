"""Agent registry (twin of navillm_tpu/agents/__init__.py; reference
tasks/agents/__init__.py:12-14): the navigation agents ``r2r``,
``r2r_aug``, ``cvdn``, ``reverie``, ``reverie_aug``, ``soon`` and ``eqa``
(agents/mp3d_agent.py), and ``llava`` and ``scanqa``
(agents/llava_agent.py). Another name raises KeyError, as in JAX."""
from ..utils.registry import AGENTS


def load_agent(name: str, *args, **kwargs):
    return AGENTS.build(name, *args, **kwargs)


from . import mp3d_agent, llava_agent  # noqa: E402,F401 isort:skip
