"""Build/version info (reference ``pkg/version/version.go:26-33``).

The reference injects Version/GitSHA/Built with ldflags at link time; the
Python analogue stamps this module at packaging time (see deploy/Dockerfile)
and falls back to asking git at runtime for source checkouts.
"""

from __future__ import annotations

import subprocess

VERSION = "0.2.0"
GIT_SHA = "unknown"   # stamped by the image build
BUILT = "unknown"     # stamped by the image build


def _live_git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=__file__.rsplit("/", 2)[0],
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:
        return "unknown"


def version_string() -> str:
    sha = GIT_SHA if GIT_SHA != "unknown" else _live_git_sha()
    return f"scheduler-tpu-torch {VERSION} (git {sha}, built {BUILT})"
