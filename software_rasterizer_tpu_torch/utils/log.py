"""The package's logger (stdlib logging).

The reference logs through spdlog (PathTracing.cpp:42,90-94). Timed
spans of the program's stages are `utils/profiling.span`.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("software_rasterizer_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
