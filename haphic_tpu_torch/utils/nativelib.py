"""Native artifact management: locate, (re)build, and safely load the
C++ helpers under native/ (the reference's native-tool tier,
SURVEY.md §2.2 — allhic GA kernel, BAM reader, filter_bam,
agp_to_fasta, juicer).

Binaries are NOT committed: they are built on demand with the
repo Makefile and rebuilt whenever a source file is newer than the
artifact, so edits to the .cpp sources can never be silently shadowed
by a stale build. Loading failures (missing toolchain, incompatible
glibc/arch) degrade to None so callers fall back to their device or
pure-Python paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          '..', '..', 'native')


def ensure_native(target: str, sources: Sequence[str]) -> Optional[str]:
    """Absolute path to an up-to-date native artifact, building it via
    ``make -C native <target>`` when missing or older than any of its
    sources. Returns None when the artifact cannot be produced. The
    check and the build hold an exclusive lock on native/.<target>.lock:
    the processes of a multi-process run start together, and one must
    not load an artifact another is still writing."""
    path = os.path.join(NATIVE_DIR, target)
    srcs = [os.path.join(NATIVE_DIR, s) for s in sources]
    have_src = any(os.path.exists(s) for s in srcs)
    if not have_src:
        return path if os.path.exists(path) else None
    with open(os.path.join(NATIVE_DIR, '.{}.lock'.format(target)),
              'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stale = os.path.exists(path) and any(
            os.path.exists(s) and os.path.getmtime(s) > os.path.getmtime(path)
            for s in srcs)
        if not os.path.exists(path) or stale:
            try:
                subprocess.run(['make', '-C', NATIVE_DIR, target],
                               check=True, capture_output=True)
            except Exception as e:
                logger.warning('building native/%s failed (%s)', target, e)
    return path if os.path.exists(path) else None


def load_shared(target: str, sources: Sequence[str]
                ) -> Optional[ctypes.CDLL]:
    """ensure_native + ctypes.CDLL, degrading to None on any load
    error (e.g. an incompatible prebuilt .so on a different host)."""
    path = ensure_native(target, sources)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        logger.warning('loading native/%s failed (%s); using the '
                       'non-native path', target, e)
        return None
