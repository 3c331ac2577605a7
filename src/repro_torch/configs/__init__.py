"""Assigned architecture configs (exact published hyperparameters).

The reference's ``configs/shapes.py`` (abstract per-cell input specs) waits
for the port's census on the meta device (``ROADMAP.md``).
"""
from .registry import ARCH_IDS, all_configs, get_config, get_smoke  # noqa: F401
