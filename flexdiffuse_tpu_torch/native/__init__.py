"""Host-side native code behind ctypes (port of
``flexdiffuse_tpu/native``): the CLIP BPE merge loop (:mod:`.bpe`), the one
super-linear host loop in prompt encoding.

``csrc/<name>.cpp`` is built with ``g++`` at first use into
``flexdiffuse_tpu_torch/_build/`` under a name keyed by a hash of the
source and the flags, never next to the sources. This is host code, not a
kernel: a consumer treats it as an optimisation with a pure-Python
fallback, so a failed build logs and the caller uses Python.
``FLEXDIFFUSE_NATIVE=0`` forces pure Python.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

log = logging.getLogger(__name__)

_CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
FLAGS = ('-O2', '-std=c++17', '-shared', '-fPIC')
_lock = threading.Lock()
_cache: dict = {}


def disabled() -> bool:
    """The kill switch: ``FLEXDIFFUSE_NATIVE=0`` forces pure Python."""
    return os.environ.get('FLEXDIFFUSE_NATIVE', '1') == '0'


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cpp`` for the current source and
    flags lives."""
    h = hashlib.sha256((_CSRC / f'{name}.cpp').read_bytes())
    h.update(' '.join(FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def load(name: str) -> ctypes.CDLL:
    """Build (if missing) and open ``csrc/<name>.cpp``. Raises on any
    failure; callers catch and fall back to Python."""
    with _lock:
        if name in _cache:
            return _cache[name]
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                lib = os.path.join(tmp, so.name)
                cmd = ['g++', *FLAGS, '-o', lib, str(_CSRC / f'{name}.cpp')]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=120)
                if proc.returncode != 0:
                    raise RuntimeError(f'native build failed: {" ".join(cmd)}'
                                       f'\n{proc.stderr}')
                os.replace(lib, so)   # atomic against concurrent builds
            log.info('built native library %s', so)
        lib = ctypes.CDLL(str(so))
        _cache[name] = lib
        return lib
