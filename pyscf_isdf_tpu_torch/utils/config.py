"""Global configuration tier (environment variables and a user config file).

The reference's three tiers (pyscf/__config__.py:10-39): environment
variables, an optional user config file executed into this module's
namespace, and per-call defaults read through :func:`get`. The variable
names are the JAX package's. They are parsed for parity only: no code of
either package reads MAX_MEMORY, VERBOSE or ISDF_DEFAULT_C yet.

    PYSCF_ISDF_TPU_MAX_MEMORY   host build memory budget (MB)
    PYSCF_ISDF_TPU_VERBOSE      default log level
    PYSCF_ISDF_TPU_ISDF_C       default ISDF compression
    PYSCF_ISDF_TPU_CONFIG_FILE  python file executed here at import
"""
from __future__ import annotations

import os

MAX_MEMORY = int(os.environ.get("PYSCF_ISDF_TPU_MAX_MEMORY", 16000))
VERBOSE = int(os.environ.get("PYSCF_ISDF_TPU_VERBOSE", 3))
ISDF_DEFAULT_C = float(os.environ.get("PYSCF_ISDF_TPU_ISDF_C", 8.0))

_conf_file = os.environ.get("PYSCF_ISDF_TPU_CONFIG_FILE", "")
if _conf_file and os.path.isfile(_conf_file):
    with open(_conf_file) as _f:
        exec(_f.read())


def get(name: str, default=None):
    """A config attribute, or ``default`` (the reference's getattr pattern)."""
    return globals().get(name, default)
