"""Logging: a thin stdlib wrapper with one shared formatter.

Port of `opencl_path_tracer_tpu/utils/logging.py`: the same logger name
("ptx"), the same one-letter-level format on stderr, the level from the
PTX_LOG environment variable (INFO by default) and no propagation to the
root logger, so library users can silence or redirect the messages the
reference prints with bare printf (main.cpp:389-455, 573-580, 629,
1236).
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "ptx") -> logging.Logger:
    """The logger `name` (a child of "ptx" by convention); the first call
    configures "ptx"'s handler and level."""
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(name)s %(levelname).1s] %(message)s"))
        root = logging.getLogger("ptx")
        root.addHandler(handler)
        root.setLevel(os.environ.get("PTX_LOG", "INFO").upper())
        root.propagate = False
        _CONFIGURED = True
    return logger
