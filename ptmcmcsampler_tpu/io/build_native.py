"""Build the native chainio library: ``python -m ptmcmcsampler_tpu.io.build_native``.

The shared library is built from ``csrc/chainio.cpp`` into ``csrc/`` (listed
in ``.gitignore``); ``io/native.py`` loads it when present and otherwise
falls back to the numpy formatter.
"""

from __future__ import annotations

import os
import subprocess
import sys

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc"
)


def build(out=None, verbose=True):
    """Compile ``csrc/chainio.cpp``; returns the library path, or None."""
    src = os.path.join(CSRC, "chainio.cpp")
    out = out or os.path.join(CSRC, "libchainio.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", out, src]
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
    except (subprocess.CalledProcessError, FileNotFoundError) as err:
        if verbose:
            print(f"native chainio build failed ({err}); numpy fallback will be used")
        return None
    return out


if __name__ == "__main__":
    path = build()
    sys.exit(0 if path else 1)
